#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``nonlinearsolve_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--log PATH] [--only 19,20,...,28]

Needs one CUDA device (an H100: the kernels are built for sm_90a); exits
non-zero without one, and without the package beside it.  Each phase
prints one JSON line (``--log`` also appends every line to PATH); a failed
check raises, so the script exits non-zero.  ``--only`` runs phases 1
and 2, then the listed phases of 19–28 alone, each timed, on the set-up
they take from earlier phases rebuilt (``only_phases``), and prints no
result line.

1. device: the card's name, and its name and power limit as nvidia-smi
   gives them (on a line of their own);
2. build: nvcc of every kernel source (and of ``bench/rd3d_designs.cu``,
   K9-K11's first design) and g++ of ``csrc/sparsetools.cpp``, all started
   together, each timed;
3. kernels: K1 (brusselator_jvp) and K2 (brusselator_jvp_scaled, planar
   and interleaved) on the card against their plain PyTorch versions —
   N=512 and N=2048, f32 and f64, K2's max equal to max|out| of its own
   output exactly, and a NaN that must come out of K2's absmax; K2 in a
   CUDA graph replayed 200 times with a new inv_scale each time (every
   replay's max exact), and two such graphs replayed side by side on two
   streams (each max exact: launches share no state).  First
   ``stencil_timings``: the time of one call of each wrapper (K1, K2 with a
   float and a tensor inv_scale, K3, the bf16 matvec on an f32 tangent) at
   N=512 and 2048, the launches of each call (the nodes it puts in a CUDA
   graph: one a wrapper, two for K2, whose max's word a one-thread kernel
   zeroes first) and their device time (torch.profiler), and the chain
   step.  Then K4 (dia_spmv) and K5's unit-data variant (gather_select)
   on the DIA route's tables (the 512² Brusselator's 11 diagonals and its
   assembly selection) with seeded data, f32 and f64, with pad slots of
   inf that K4 must not read.  Times are CUDA-event times per call over
   ≥ 200 calls replayed from a CUDA graph (device time, no host gaps); the
   bound is the bytes read once and written once over 3.35 TB/s, or the
   operations over the peak rate, whichever is larger; the library call
   beside K4/K5 (cuSPARSE through ``torch.sparse_csr_tensor``,
   ``torch.take``) is timed by its kernels' device time under
   torch.profiler over eager calls (the kernel is timed that way too, for
   a like-for-like pair).  K3 (brusselator_jvp_bf16) at N=512 and 2048,
   bf16, must be bit-equal to its plain version, and the bf16 matvec
   (``make_brusselator_jvp_bf16``'s mv, one launch of K3's f32 variant) on
   the f32 tangent bit-equal to cast -> K3's plain version -> cast;
4. main path, with every launch counter set to 0 just before and read just
   after: the chained, normalised matvec of the throughput row
   (bench.py:92-108, K2) and the flagship solve at bench.py:134-140's
   operating point (N=512 f32, NewtonRaphson + GMRES(8) + the FFT Poisson
   preconditioner, η = 0.1, abstol 5.0, maxiters 30; K1 in every Krylov
   iteration).  Checks: Success, |resid|_inf ≤ 5, 8204 forced points, K1
   launches equal to the solve's Jacobian products, K2 launches equal to
   the chain's steps.  Then the wall time of warm solves;
5. f64 polish on the card from the f32 root (tools/golden_polish.py's
   settings); the f32 root must lie within rel-inf 1e-2 of the f64 root;
6. sparse path (counters at 0 just before, read just after): the same
   solver with a colored sparse-AD Jacobian (8 JVPs a step, assembled into
   DIA by K5's selection, K4 in every GMRES product) on the flat 512²
   Brusselator, f64, abstol 1e-4.  Checks: Success, |F|_inf ≤ 1e-4, 8
   colors, 11 diagonals, selection launches = Jacobians, K4 launches =
   Jacobian products, no K1 or CSR K5 launch, the root within rel-inf 1e-3
   of phase 5's.  The one-time host plan is timed apart from the warm
   solves; then the f32 variant at abstol 5.0 (reported, not required to
   succeed: the JAX package stalls at |F| = 7.6 there);
7. CSR route (counters at 0 just before, read just after): the 512²
   Brusselator with its unknowns permuted by a seeded permutation (beyond
   the DIA tier: the JAX package's "resident" tier, after RCM), the same
   solver, f64, abstol 1e-4.  Checks: Success, the resident tier, K5
   (gather_spmv) launches = Jacobian products, selection launches =
   Jacobians, no K4 launch, and the root, permuted back, within rel-inf
   1e-8 of phase 6's.  Then K5 and its selection are checked and timed on
   this route's own tables (the permuted pattern, the Jacobian at the root
   as data), f32 and f64; K5 here and in phases 12 and 13 also launched
   twice (bit-equal) and timed beside the index_select yardstick;
8. 3D kernels: K9 (rd3d_jvp_blocked: bz 4 and 8, double_buffer off and
   on) and K10 (rd3d_jvp_scaled: bz 4 and 8) on the card against their
   plain versions — 256³ and (40, 72, 100) (ny, nx not multiples of a
   warp), f32 and f64, seeded on the card by a torch.Generator, and a NaN
   that must come out of K10's absmax; each bit for bit the first design
   of the same kernels (``bench/rd3d_designs.cu``: one thread a column) at
   every bz, K10's max too; the 256³ cases timed as above, in the
   configurations the 3D path runs (K9 bz=4 double-buffered, K10 bz=8),
   the first design timed beside each in turns (new, first, first, new);
9. 3D chain (counters at 0 just before, read just after): the chained,
   normalised matvec of examples/07_3d_reaction_diffusion_tpu.py:82-117 at
   256³ f32 (K10, the scale kept on the device), K10 launches = steps;
   its step time by CUDA events, from a CUDA graph and by the chain-length
   slope (``utils.profiling.slope_time``), as 8·N³ nnz per step;
10. 3D solve (counters at 0 just before, read just after): the example's
   operating point, 256³ f32 through ``reaction_diffusion.make_problem(256,
   kernel_jvp=True)`` (NewtonRaphson + GMRES(8), krylov_maxiter 200, the
   FFT Poisson preconditioner on (N, N, N), shift −0.9, η = 0.1, abstol
   1e-5·N, maxiters 30).  Checks: Success, |F|_inf ≤ 2.56e-3, K9 launches
   = Jacobian products, no K1, K2, K4, K5 or K10 launch; the NLStats beside
   the JAX package's on the CPU (6 steps, nf 8, njacs 6).  Then warm wall
   times, the device time by kernel group and the idle share under
   torch.profiler, and the chained time to solve
   (``utils.profiling.chained_solve_time``);
11. 3D f64 polish on the card from the f32 root (abstol 1e-10, K9 in f64):
   the f32 root must lie within rel-inf 1e-4 of it;
12. band route (counters at 0 just before, read just after): the 3D solve
   of phase 10 at 256³ f32 with a colored sparse-AD Jacobian on the flat
   state (``JacobianPolicy(mode="sparse")``, the periodic 7-point pattern
   built with numpy), which the JAX package's tier selection sends to its
   "stream" tier: K7 (band_spmv) in every GMRES product.  The host plan is
   timed by step (pattern, coloring, band plan, the rest of the tier
   selection, the pack tables).  Checks: tier "stream", no reorder, w 11,
   5 bands; Success, |F|_inf ≤ 1e-5·N, nsteps within 1 of phase 10's, K7
   launches = Jacobian products, selection launches = 2 × Jacobians
   (decompression and pack), no K4, CSR K5, K8 or K9 launch, the root
   within rel-inf 1e-4 of phase 11's.  Then warm walls, the device time by
   kernel group, the idle share and peak memory; K7 against its plain
   version on the route's own tables (the Jacobian at the root), f32 and
   f64, with inf in every pad slot (y bit-equal), timed beside K5 on the
   same matrix and cuSPARSE;
13. scatter route (counters at 0 just before, read just after): the same
   problem at 96³ f32 with its unknowns numbered by
   ``np.random.default_rng(42).permutation``, which the JAX package sends
   to its "scatter" tier (3 column parts, one R plan each): K8
   (scatter_spmv_part, one launch a part) in every product.  Checks: the
   tier and parts; Success; K8 launches = 3 × products, selection
   launches = 2 × Jacobians, no K4, CSR K5, K7 or K9 launch; the root,
   permuted back, within rel-inf 1e-4 of the natural-order solve at 96³
   in the same phase (the DIA tier, K4).  Then warm walls and the device
   profile; K8's product on the route's own tables, f32 and f64, bit for
   bit against its sequential reference (the plain products, each R level
   summed slot by slot, the parts added in order), then K5 on the same
   matrix as CSR, each timed beside cuSPARSE of A and the index_select
   yardstick (YARDSTICK);
14. the bf16 path (counters at 0 just before each run, read just after):
   the flagship's solve with ``krylov_basis_dtype="bf16"`` — run (a) with
   K1, run (b) with K3 as the problem's jvp (docs/solvers.md's
   mixed-precision problem).  Checks: the retcode the JAX package gives on
   the CPU at this operating point (JAX_BF16_FLAGSHIP: MaxIters for both),
   nsteps within 2 of its, nf equal, K1 (a) or K3 (b) launches = Jacobian
   products and none of the other; run (a) with its root within rel-inf
   1e-2 of phase 5's (as any run that succeeds) and |F|_inf at most
   BF16_A_RESID_INF_MAX; run (b) with u equal to u0 bit for bit and
   |F|_inf within rel 1e-6 of the JAX package's, as there.  Then 8 Arnoldi
   iterations at u0 with the f32 and
   the bf16 basis, timed in turns (wall and device time);
15. K11 (rd3d_jvp_blocked_halo) on z-slabs, each given its neighbours'
   planes: bit-equal to K9 on the whole grid at 256³ (4 and 8 slabs) and
   (40, 72, 100) (4 slabs, bz 5), f32 and f64; against its plain version
   at TOL, f32 and f64, on a 64-plane shard and on the whole 256³ grid as
   one shard (there also bit-equal to K9); every slab and shard bit for
   bit the first design's; timed at f32 on both, the first design beside
   it in turns;
16. the distributed entry point (counters at 0 just before, read just
   after): NCCL at world size 1 (``init_process_group`` with a HashStore),
   ``parallel.scaling.weak_scaling_report([1], base_n=256, n_matvecs=50,
   use_pallas=True, bz=8)``.  Checks: one row, a finite rate, 100 K11
   launches (the report's warm-up chain and its timed chain, 50 each, as
   the JAX package's report runs them), no K9 or K10 launch; the rate
   beside phase 9's K10 chain;
17. the block-sparse layer (counters at 0 just before, read just after):
   phase 6's f64 Jacobian at its root, assembled once with the plan as CSR
   (outside the count), reblocked by ``BSR.from_csr(J, 2)`` (each grid
   point's two species one 2×2 block).  Checks: 1,310,720 blocks, 5 a
   block row, ``diag_blocks()`` (262144, 2, 2); K6 (``bsr_spmm``) times
   the 8 colour seeds equal to the compressed colored JVPs at the same u
   bit for bit; ``Jb.matvec`` (K5 on the expanded pattern) against the CSR
   J's product at TOL; ``block_jacobi_preconditioner(Jb.diag_blocks())``
   applied to D·v gives v back at TOL; K6 launches = products, one K5
   launch, no K4, K7 or K8 launch.  Then K6 against its plain version at
   nrhs 8 and 37, f32 and f64, seeded X, timed beside cuSPARSE (BSR ×
   dense, or CSR × dense on the expanded pattern where torch refuses it)
   and K5 on the expanded pattern once per column (with its index_select
   yardstick); each record carries K6's launch plan
   (``spmv.bsr_spmm_plan``) and staged chunk, and the kernels line names
   K6's design;
18. the dense Brusselator, the tutorial's dense rung (counters at 0 just
   before each run, read just after): ``make_problem(32)``, f64, 2048
   unknowns, a 2048×2048 forward-AD Jacobian, abstol 1e-10, solved by
   NewtonRaphson (LU through cuSOLVER), TrustRegion, LevenbergMarquardt
   (at abstol 1e-8: at 1e-10 it stalls at the floor of its least-squares
   step, in the JAX package too) and PseudoTransient(alpha_initial=10).
   Checks: Success for each, each
   root within 1e-8 (inf-norm) of the sparse-AD root (phase 6's colored
   Jacobian, GMRES + FFT) and of the matrix-free Newton–GMRES–FFT root at
   the same N (tests/test_golden_models.py:48-70's ladder), no custom
   kernel launched.  Then NewtonRaphson at N=64 (8192 unknowns, a 512 MiB
   Jacobian; abstol 1e-9, above the f64 floor of |F| there).  For each
   run: the warm wall (median of 3; LevenbergMarquardt, 16 s a solve,
   takes one solve, timed and not profiled: the profiler's processing of
   it took another minute, cut for phase 28's time), NLStats,
   host syncs, the device time by class
   (the Jacobian's batched residual, timed alone; the dense linear algebra
   by kernel name; the rest) and the idle share;
19. the 23-problem suite on the card (counters at 0 just before, read just
   after): NewtonRaphson, TrustRegion and LevenbergMarquardt on the 23
   problems, f64, maxiters 10000, ‖f(u*)‖∞ ≤ 1e-4 as
   tests/test_23_problems.py holds it; each broken set equal to the JAX
   package's CASES row (NR {1}, TR {11, 21}, LM {11, 21}), NR's problem
   1 (10000 steps) left to tests/test_torch_cuda.py.  Then
   GaussNewton, LevenbergMarquardt and TrustRegion on the 8 NLLS problems,
   each sum of squares held as tests/test_nlls_problems.py holds it
   (except that file's BROKEN pairs, which are reported);
20. the quasi-Newton, spectral and polyalgorithm engines (counters at 0
   just before each run, read just after): (a) the quickstart,
   ``solve(prob)`` with no algorithm on u² − p, u0 = [1, 1], p = 2, f64:
   Success, the root √2 within 1e-8; (b) the default polyalgorithm on the
   dense Brusselator, ``make_problem(32)``, f64, 2048 unknowns, abstol
   1e-10: Success, the root within 1e-8 (inf-norm) of phase 18's
   NewtonRaphson root, and NLStats beside the JAX package's (1026 steps,
   1032 residuals, 4 Jacobians), each rung's retcode and steps, the warm
   wall (the profiled solve's), host syncs, the device time by class and
   the idle share; (c) Broyden, Klement, LimitedMemoryBroyden and DFSane alone at
   N=32, each with the JAX package's retcode (Unstable, MaxIters,
   ConvergenceFailure, MaxIters; the diverging Broyden and
   LimitedMemoryBroyden runs may also end as the JAX package's own run
   does from a start one ulp away: Stalled, Unstable), and their steps,
   residuals and first-solve walls (the warm re-runs cut for time);
   (d) the quasi-Newton / polyalgorithm rows of
   tests/test_23_problems.py CASES on the 23 problems (f64, maxiters
   10000, ‖f(u*)‖∞ ≤ 1e-4), each case that takes under 1000 steps in the
   JAX package on its CASES side, and the two n = 64 rows
   (``LARGE_N_CASES``); the cases of 1000 JAX steps or more run in
   tests/test_torch_cuda.py.  No custom kernel is launched;
21. the sparse direct route (counters at 0 just before each run, read
   just after), f64, NewtonRaphson with a colored sparse-AD Jacobian:
   (a) BASELINE config 3, Bratu 32², the default linear solver: block
   cyclic reduction, the root within 1e-10 of the dense NewtonRaphson
   root; (b) SNES ex2, n = 128, sparse: PCR, within 1e-8 of the dense
   root, u[0] and u[-1] to 1e-10; (c) Bratu 128²: the AMD host LU, one
   factorization then numeric refactorizations, the root within 1e-10 of
   the CPU port's; (d) Bratu 128² with ``sparse_lu_device``: the JAX
   package's plan (12 + 43 stages, 28 ELL), K5 on every gather of every
   solve; (e) Bratu 128² flat, GMRES with ``precond="device_lu"``: K4 in
   every product, 1–3 Krylov iterations a step; (f) Bratu 256² (65,536
   unknowns): BiCGStab with a Jacobi preconditioner over K4, the root
   within 1e-10 of the CPU port's.  Each run: the JAX package's retcode,
   nsteps and nf (``JAX_SPARSE_DIRECT``), the route it takes, max|F|, the
   warm wall (the profiled solve's), host syncs, the device time by class
   and the idle share.  Then (g): DeviceLU.solve on the card against the port's
   CPU solve of the same state (rel-inf 1e-12, f64), its time at 128² f64
   and 64² f32 (CUDA events over 20 solves), its kernels and the refresh's
   parts; K5 on every gather table of the 128² plan against its plain
   version (f64 and f32, at TOL), the gathers of one solve timed together
   beside cuSPARSE on the same stage CSRs and their byte bound.  Then (h):
   K4 on the "dia" tier of the Jacobians of (e) and (f) at their roots
   (at TOL) and K5's selection on the CSR assembly tables of (a), (c) and
   (f) (bit for bit), f64 and f32, against their plain versions;
22. the batched tier (counters at 0 just before each run, read just
   after), f64: (a) the simple rows of tests/test_23_problems.py CASES,
   lone solves at maxiters 10000, the cases of under 1000 JAX steps: the
   broken sets equal to CASES'; (b) problem 9 (discrete boundary value,
   n = 10) from 262,144 seeded starts x0·(1 + 0.1ξ), ξ ~ U(−1, 1), each
   simple engine and SimpleTrustRegion with the NLSolve.jl rule as one
   lockstep batch (``solve_ensemble``, maxiters 200); (c) problem 10 lifted to n = 64,
   16,384 starts, SimpleLimitedMemoryBroyden on its 27-deep ring; (d) u² −
   p, u0 = [1.0], SimpleNewtonRaphson over 1,048,576 values of p =
   linspace(0.5, 10): roots within 1e-8 of √p; (e) the eight bracketing
   methods on u² − p over (0.1, 5.0) for the same p: every code
   successful, roots within 1e-8 of √p, and ModAB's implicit-function
   derivative du/dp within rel 1e-8 of 1/(2√p).  In (b) and (c) 16
   seeded rows (cut from 64 for time), in (d) 64, are solved
   alone (B = 1): the batch's retcode and a root within rel-inf
   1e-10, and the NLStats for the Jacobian engines (the secant engines'
   differences are counted); every row that reports Success has |F|_inf
   ≤ abstol.  Each run: warm wall (the profiled run's),
   trajectories per second,
   steps of the slowest row, host reads, the device idle share and three
   largest kernels (torch.profiler) and the peak memory.  No custom
   kernel is launched;
23. differentiating through ``solve`` (counters at 0 just before each
   run, read just after): (a) the dense branch of the implicit-function
   rule at its full width, the dense Brusselator ``make_problem(32)``, f64
   (n = 2048 = ``_DENSE_IFT_LIMIT``), NewtonRaphson, abstol 1e-10: p̄ of
   ⟨w, u*⟩ over the four entries of p (w seeded) by ``torch.autograd``;
   u̇ by ``torch.autograd.forward_ad`` for ṗ = e_A and e_B, ⟨w, u̇⟩ equal
   to p̄'s entry within rel 1e-10; p̄ within rel 1e-5 of central
   differences of two f64 solves an entry (step 1e-4 relative); the
   TrustRegion and default-polyalgorithm p̄ within rel 1e-8; no kernel
   launched.  (b) The Krylov branch at the flagship's width: phase 5's
   f64 polish (Newton–GMRES(16)–FFT with K1, 524,288 unknowns) with p
   requiring grad, p̄ by GMRES on the residual's vjp (restart 50, 500
   iterations, rtol 1e-8, unpreconditioned as in the JAX package): the
   wall, the iterations, the adjoint solve's relative residual, p̄ and its
   gap to central differences (solves at abstol 1e-8) are printed.  (c)
   The reverse rules of K5, K7 and K8 run in phases 7, 12 and 13 on those
   routes' matrices and plans (``reverse_rule_check``): d̄ata bit for bit
   and x̄ within rel-inf 1e-12 (f64) or 1e-6 (f32) of autograd through the
   plain CSR product on the card, the kernel launched by the backward on
   Aᵀ's tables (the structurally symmetric patterns reuse their forward
   plan), the backward and its x̄ launches timed by CUDA events beside
   their byte bound and cuSPARSE's Aᵀ·ȳ.  (d) One grad-mode call each to
   K1 and K4 raises, naming the kernel, and so does a forward-mode
   tangent through K1 and through ``CSR.matvec``.  (e) The f32 flagship through
   ``init`` → two ``step``s → ``solve``: the retcode, NLStats and root of
   ``solve`` bit for bit; ``store_trace=True`` and
   ``time_phases=True`` (a trace entry a step, the root unchanged, the
   phases within 10 % of the wall); ``reinit(u0=root, p=p with A +
   1 %)`` warm-starts the dense f64 Newton of (a) (fewer steps than the
   cold solve); the dense Brusselator with ``lb=0`` under TrustRegion
   (NewtonRaphson ends Unstable from u0's zeros, in the JAX package too)
   reaches the unbounded root within 1e-8; that solve under a
   termination mode that keeps no best iterate (AbsNormSafe), longer
   than one chunk of ``_STEP_CHUNK`` steps, through a cache's
   ``solve(maxtime=...)`` with half its first chunk's wall stops with
   MaxTime after 0 < nsteps < its steps, and the cache's next ``solve()``
   gives its root and NLStats bit for bit (the default safe-best mode
   resumes from the best iterate, as the JAX package does, and may take
   other steps);
24. continuation and the other problem types (counters at 0 just before
   each run, read just after), f64: (a) the Bratu λ-continuation,
   ``HomotopyProblem`` with H = bratu_2d(u, λ), u0 = 0, λ from 0 to 6.5,
   abstol 1e-8, at N = 32 (BASELINE config 3's grid) and 64, under
   HomotopySweep, KantorovichHomotopy and ArcLengthContinuation with a
   NewtonRaphson inner and the default HomotopyPolyAlgorithm: Success,
   |H(u, 6.5)|_inf ≤ 1e-8, the four roots within 1e-9 of each other, the
   NLStats of the JAX package on the CPU, its last λ and max u within
   1e-10 and its Σu within 1e-8 (JAX_CONTINUATION), no kernel launched;
   each run's first and warm wall, host reads, idle share and device time
   by class (CONTINUATION_GROUPS) under torch.profiler.  Then
   the three methods at N = 32 at the default abstol: the JAX package's
   MaxIters, their counts and last λ beside its own
   (JAX_CONTINUATION_FLOOR).  (b) p scaling λ,
   H = bratu_2d(u, λ·p), p = 1, N = 32 and 64, the sweep: p̄ of ⟨w, u⟩ (w
   seeded) by reverse mode within rel 1e-12 of forward mode and within
   rel 1e-6 of the fourth-order central difference (step 1e-3; each point
   a NewtonRaphson solve at λ = 6.5·p, abstol 1e-10, from the root).  (c)
   ``SteadyStateProblem`` on Bratu 32² at λ = 3.5: DynamicSS
   ("rosenbrock23") Success within 1e-6 of the NewtonRaphson root,
   DynamicSS("tsit5") with the JAX package's retcode (MaxIters), the
   NLStats beside the JAX package's (JAX_DYNAMIC_SS); the f32 flagship of
   phase 4 as a SteadyStateProblem under ``SSRootfind``: its root and
   NLStats bit for bit those of the NonlinearProblem solve, K1 launches =
   its Jacobian products.  (d) An ``SCCNonlinearProblem``: Bratu 32² at
   λ = p = 3.5, a ``LinearSCCBlock`` A = J(u₁*) (dense jacfwd), b = −e^{u₁*}
   (du/dλ), and a HomotopyProblem block H = bratu_2d(u, λ·(p + mean
   u₁*)), abstol 1e-10: each block's u equal to its lone solve, Success,
   the NLStats the blocks' sum, ∂⟨w, u⟩/∂p by reverse mode within rel
   1e-12 of forward mode and rel 1e-6 of the central difference.  (e) The
   ``run_flat`` Richardson iteration of tests/test_interfaces.py on the
   card, and ``SciPyRoot("hybr")`` on Bratu 16² from a card u0: the root
   within 1e-8 of NewtonRaphson's, ``sol.u`` on the card;
25. pytree, 0-d and complex states, normal-form Krylov least squares,
   the polynomial drivers and the C.3 / C.4 repairs (counters at 0 just
   before each run, read just after), f64 / complex128: (a) the N = 32
   dense Brusselator (2048 unknowns) as a dict state {"u", "v"} of two
   32×32 tensors under NewtonRaphson and Broyden: Success, the retcode,
   NLStats and root (within 1e-12) of the solve on the flat vector in the
   same order, and for NewtonRaphson the shaped (N, N, 2) solve's NLStats
   and root within 1e-12; u² = 2 from a 0-d u0 under NewtonRaphson.  (b)
   u³ − 8 from −0.8 + 1.5i under NewtonRaphson, Broyden, Klement and the
   default ladder, and the N = 32 Brusselator on a complex128 state
   (init_u0 + 1e-3·i·z, z seeded) under NewtonRaphson (the complex
   Jacobian's LU is cuSOLVER's getrf): the JAX package's retcode and
   NLStats (JAX_COMPLEX), Re u within 1e-10 of the real root and |Im u|
   under 1e-10, its walls, idle share and device time by class.  (c) The
   complex least-squares fit of tests/test_core_solvers.py under
   GaussNewton (the JAX package's NLStats); complex GMRES and BiCGStab on
   a seeded 4096² system within 1e-10 of LU.  (d) Normal-form Krylov
   least squares: the N = 128 Brusselator residual (32,768 unknowns)
   less its value at a seeded state u_t, stacked with 1e5·(u − u_t)
   (65,536 rows), from init_u0 under GaussNewton with CG on JᵀJ
   (matrix-free, vjp∘jvp), abstol 1e-6: Success at u_t within 1e-10, the
   Krylov iterations, ‖Jᵀr‖∞ down 1e-8 or more from u0's.  (e) The polynomial drivers: the JAX tests'
   systems (the cubic, the 2×2 system, the parametrised polynomial,
   Wilkinson-6) with the root sets of the port's CPU run within 1e-10; a
   seeded dense quadratic system with n = 9 (512 total-degree paths in
   one lockstep batch, one γ): paths, steps, host reads, distinct roots
   (equal to the port's CPU run, which a second process of this script
   computes meanwhile: ``--poly-reference``), the largest root residual,
   first and warm wall and idle share (the warm walls and profiles of
   (b), (d) and this system are taken after that process has ended, the
   first walls beside it), and two lone tracks within 1e-12
   of their batch rows (the residual's einsum contracts otherwise at
   batch size 1; every path of the cubic, 2×2 and parametrised systems,
   elementwise, alone is its batch row bit for bit);
   ``solve_multistart`` and ``HomotopyContinuationJL``
   on one JAX test problem each.  (f) C.3 (the eight bracketing methods
   on log(u) − ½ over (−1, 3) and u − p over a NaN row, lone and batched,
   maxiters 100: the CPU run's codes, nf and u, Success on the NaN row
   for Bisection, Falsi, Brent and ModAB as in the JAX package) and C.4
   (a singular Jacobian: a NaN gradient, no exception);
26. complex states under the engines that order values, sparsity
   detection and double-f32 refinement (counters at 0 just before each
   run, read just after), after phase 25 has waited for its CPU
   reference; ``--only 26`` runs it alone.  (a) u³ − 8 (written u·u·u,
   the JAX package's integer_pow) from −0.8 + 1.5i (complex128), the
   default abstol, under LevenbergMarquardt, TrustRegion,
   AndersonAcceleration, SimpleTrustRegion and SimpleDFSane: the JAX
   package's retcode and
   NLStats (JAX_ORDERED, tools/complex_reference.py); RobustMultiNewton
   and PseudoTransient refused (the JAX package fails to trace them); the
   N = 32 Brusselator on a complex128 state (2048 unknowns, phase 25
   (b)'s start) under TrustRegion: the JAX package's NLStats, Re u within
   1e-10 of the real f64 TrustRegion root, |Im u| under 1e-10.  (b)
   ``detect_sparsity`` on the flat 512² Brusselator residual (524,288
   unknowns, no ``sparsity=``): the pattern equal to
   ``sparsity_pattern(512)``, and on phase 7's permuted residual equal to
   (pinv[rows], pinv[cols]), each with its host seconds; then phase 6's
   sparse path on the residual with no pattern: its retcode, NLStats and
   root bit for bit phase 6's, K4 launches = Jacobian products, selection
   launches = Jacobians.  (c) ``two_sum`` / ``two_prod`` error-free on
   2²² seeded f32 pairs (checked in f64) and ``self_check``; phase 4's f32
   root refined by ``refine_root`` with ``brusselator_2d_df32``, K1 as
   the Jacobian product and the FFT preconditioner at bench.py:189-192's
   operating point (REFINE): within 1e-8 rel-inf of phase 5's f64 polish,
   the defect, the fast root's distance, the first and warm walls and the
   K1 launches.  (d) ``auto_refine`` (the residual traced once and its
   graph evaluated in double-f32 each round, df_exp included) on Bratu 128² solved in f32 by the sparse direct route
   (BRATU_REFINE): within 1e-9 rel-inf of the f64 solve and 10× nearer
   than the f32 root;
27. multigrid, the matrix-product DFT / hybrid preconditioners and the
   sharded layer (counters at 0 just before each run, read just after);
   ``--only 27`` runs it alone.  (a) Newton–GMRES(20) with
   ``multigrid_preconditioner`` (c = 1, Dirichlet) on Δ_h u − u³ − u + g
   at 1024² f64 (tests/test_sparse_krylov.py:576-597's problem, abstol
   1e-9·(N/32)²): Success, no kernel launched, the V-cycle's apply time;
   GMRES(30) iterations on the variable-coefficient operator at 256²
   unpreconditioned, with Jacobi and with Chebyshev multigrid (Chebyshev
   ≤ Jacobi, multigrid < 1/5 of none).  (b) On the 512² f32 flagship: the
   ``mxu_poisson_preconditioner`` apply's error against the FFT apply for
   each precision name, and the apply times; the flagship solved under
   mxu("highest") and under ``hybrid_poisson_preconditioner`` (switch
   0.1·‖F(u0)‖∞): retcode, NLStats, K1 launches (= Jacobian products),
   the linearizations of each branch, the root's distance to phase 5's
   polish (a stall is recorded, not required).  (c) NCCL at world size 1:
   phase 7's Jacobian at its root through ``make_sharded_csr_matvec``
   (one K5 launch a product, bit for bit K5 on the shard's tables and the
   unsharded K5 product; K5 on the shard tables timed by ``k5_case``); the
   JAX multihost problem A u + 0.1u³ − b with A banded at MULTIHOST_N²
   rows through the sharded matvec (Success, the root within 1e-6 of the
   same solve through ``CSR.matvec``); the config-5 shape at 128² (the
   Jacobian by colored sparse AD each step, applied through the sharded
   matvec's K5 tier, multigrid-preconditioned GMRES(40): |F|∞ ≤ 1e-8,
   within 1e-6 of ``solve`` with ``jac_prototype``); and
   ``weak_scaling_sparse_report([1], rows_per_device=1<<22)`` (100 K5
   launches).  (d) ``distributed_solve`` of the 3D problem at 256³ f32
   with phase 10's algorithm and the autodiff J·v: Success, nsteps within
   1 of phase 10's, the root within 1e-4 rel-inf of it, ``sol.u`` a
   DTensor with Shard(0); wall and idle share.  (e)
   ``solve_ensemble(mesh=)`` of phase 22's problem-9 batch (262,144
   starts, SimpleNewtonRaphson): every row bit for bit the unsharded
   ensemble's.  (f) ``distributed_solve`` of the 512² f32 flagship
   residual (phase 4's algorithm, abstol 5) with the autodiff J·v under
   Shard(0) and Shard(1): the retcode and nsteps of the unsharded solve
   with the same (reverse-over-reverse) J·v, roots within 1e-4 rel-inf of
   it, ``sol.u`` in the requested placement, the unsharded solve with the
   forward-mode J·v beside them; walls, host reads, ``_backend.COLLECTIVES``,
   DTensor's collectives in one J·v and the idle share.  At world size 1
   every shard is the whole grid: this holds the port's DTensor rules
   (``parallel/dtensor_rules.py``) to the card's torch, not a shard's
   sizes (the gloo tests do that).  (g) The residual idioms of ROADMAP
   C.10 (``torch.roll``, ``index_select``, ``X[..., idx]``) on a (64, 64,
   2) f64 state under Shard(0) and Shard(1): the AD J·v within 1e-12 of
   ``torch.func.jvp`` unsharded, in the state's placements, and which
   rules this torch takes from the port;
28. lockstep first-order ensembles and the AOT round trip, f64, counters
   at 0 just before each run (``--only 28`` runs it alone).  (a) The
   23-problem #9 (n = 10) from 65,536 seeded starts under NewtonRaphson,
   NewtonRaphson with BackTracking, TrustRegion (simple and Fan),
   LevenbergMarquardt and the default ladder (``solve_ensemble`` with no
   algorithm: Broyden, Klement, then the Newton rungs); (b) the 8×8 dense
   Brusselator (128 unknowns) over 1024 seeded values of A under
   NewtonRaphson, TrustRegion and the default ladder at abstol 1e-10
   (phase 18's; the residual's floor is about 1e-12; the default
   ladder's rows take about 1000 steps, so 8 are solved alone, and a row
   whose NLStats part from its lone solve's must take them, with its
   retcode and root, when the batch's products, dots and norms are taken
   one row at a time (``rows_one_by_one``, the witness that the batched
   products' rounding moved Broyden's stop), where the reads must not
   depend on the rows' count; the 64-row and 1024-row reads are not
   taken).  Before (a), one profiled run is read from the profiler's raw
   events and through ``key_averages()``: the two busy times must agree
   (every profile of the script reads the raw events).  Each run: the
   route ``lockstep``, no
   kernel launched, Success rows at |F|∞ ≤ abstol, the warm wall, the
   idle share, the slowest row's steps and the host reads a run, equal
   for 64 rows and for the same rows 16 times over (the rows within
   1e-12: cuBLAS's batched products may round otherwise at another batch
   size); 64 seeded rows
   solved alone give the batch row's retcode and NLStats and a root
   within 1e-12 rel-inf, their time beside the batch's.  (c)
   ``export_solver`` of NewtonRaphson on the N = 32 dense Brusselator,
   ``deserialize_solver``, a call on the card with a fresh p: bit for
   bit ``solve``'s; the ``batch="b"`` artifact at two batch sizes, each
   row within 1e-12 of its lone solve.  (d) Templates that carry more
   than the residual, N = 32 f64 on a fresh p: the Jacobian written out
   (``jac``), Newton–GMRES(8) with the FFT preconditioner's factory, and
   a dict state; each loaded solve bit for bit ``solve``'s, Success;
29. the kernels line (each SpMV kernel's row with its reverse rule's
   numbers from 23 (c), K1, K4 and the selection with their launches
   in phase 26, and K5's row with its launches and time on the sharded
   matvec of 27 (c)), then ``{"ok": true, "device": {...}}`` as the last
   line.
"""

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12             # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,       # H100 SXM, outside the tensor cores
              "float64": 34e12,
              # K3: bf16x2 on the CUDA cores, counted at the f32 rate (the
              # bound is bytes either way)
              "bfloat16": 67e12}
TOL = {"float32": 1e-5, "float64": 1e-12}   # rel-inf of max|out|
VJP_TOL = {"float32": 1e-6, "float64": 1e-12}   # x̄ of the reverse rules
FLOPS_PER_POINT = {"brusselator_jvp": 27, "brusselator_jvp_scaled": 31,
                   "rd3d_jvp": 13, "rd3d_jvp_scaled": 15}
REPLACES = {
    "brusselator_jvp": "nonlinearsolve_tpu/ops/pallas_stencil.py:104",
    "brusselator_jvp_scaled": "nonlinearsolve_tpu/ops/pallas_stencil.py:170",
    "rd3d_jvp": "nonlinearsolve_tpu/ops/pallas_stencil3d.py:299",
    "rd3d_jvp_scaled": "nonlinearsolve_tpu/ops/pallas_stencil3d.py:174",
    "brusselator_jvp_bf16": "nonlinearsolve_tpu/ops/pallas_stencil.py:183",
    "rd3d_jvp_halo": "nonlinearsolve_tpu/ops/pallas_stencil3d.py:260",
    "bsr_spmm": "nonlinearsolve_tpu/ops/pallas_spmv.py:945",
}
# The JAX package on the CPU (jax_platforms cpu, x64 on; its f32 solve) at
# phase 14's operating point, N=512: run (a) is the bf16 Krylov basis with
# the f32 matvec (Pallas K1), run (b) the bf16 basis with the bf16 matvec
# (make_brusselator_jvp_bf16).  Neither reaches abstol 5.0: the bf16
# rounding of the basis (and of the matvec) puts a floor above it.  Run (a)
# ends near the root; its final |F|_inf depends on the order of sums (47.3
# in the JAX package, 24.9 in the port on the CPU, 9.97 on the H100), so the
# card is held to BF16_A_RESID_INF_MAX, about twice the largest reading and
# far below |F(u0)|_inf = 6094.876.  Run (b) never leaves u0: its u comes
# back equal to u0 bit for bit (in the port on the CPU too), so its |F|_inf
# is |F(u0)|_inf.  (The f32-basis flagship there: Success in 22 steps,
# |F|_inf 4.994.)
JAX_BF16_FLAGSHIP = {
    "a": {"retcode": "MaxIters", "nsteps": 30, "nf": 32,
          "resid_inf": 47.31610870361328},
    "b": {"retcode": "MaxIters", "nsteps": 30, "nf": 32,
          "resid_inf": 6094.87646484375, "u_equals_u0": True},
}
BF16_A_RESID_INF_MAX = 100.0
SOURCE = "nonlinearsolve_tpu_torch/csrc/stencil.cu"
SOURCE_3D = "nonlinearsolve_tpu_torch/csrc/stencil3d.cu"
LIBRARY_NOTE = ("no single PyTorch call computes this fused stencil JVP "
                "(a convolution covers the Laplacian only)")
RD3D_SHAPES = ((256, 256, 256), (40, 72, 100))
DEVICE_GROUPS = {"K9 rd3d_jvp": ("rd3d_kernel",),
                 "K7 band_spmv": ("band_spmv",),
                 "K8 scatter_spmv_part": ("scatter_part",),
                 "K4 dia_spmv": ("dia_spmv",),
                 "K5 gather_spmv": ("csr_spmv",),
                 "K5 selection": ("csr_select",), "cuFFT": ("fft",),
                 "reductions": ("reduce_kernel", "dot_kernel"),
                 "gemm/gemv": ("gemm", "gemv"),
                 "elementwise": ("elementwise",)}
SPMV_SOURCE = "nonlinearsolve_tpu_torch/csrc/spmv.cu"
SPMV_REPLACES = {
    "dia_spmv": "nonlinearsolve_tpu/ops/pallas_stencil.py:228",
    "gather_spmv": "nonlinearsolve_tpu/ops/pallas_spmv.py:391",
    "gather_select": "nonlinearsolve_tpu/ops/pallas_spmv.py:391",
    "band_spmv": "nonlinearsolve_tpu/ops/pallas_spmv_stream.py:339",
    "scatter_spmv_part": "nonlinearsolve_tpu/ops/pallas_spmv_scatter.py:409",
}
SPMV_LIBRARY = {
    "dia_spmv": "cuSPARSE CSR matvec of the same matrix "
                "(torch.sparse_csr_tensor @ x)",
    "gather_spmv": "cuSPARSE CSR matvec (torch.sparse_csr_tensor @ x)",
    "gather_select": "torch.take of the zero-extended values",
    "band_spmv": "cuSPARSE CSR matvec of the same matrix "
                 "(torch.sparse_csr_tensor @ x)",
    "scatter_spmv_part": "cuSPARSE CSR matvec of A, the whole product "
                         "(torch.sparse_csr_tensor @ x)",
    "bsr_spmm": "cuSPARSE BSR x dense (torch.sparse_bsr_tensor @ X); where "
                "torch refuses it, CSR x dense on the expanded pattern "
                "(torch.sparse_csr_tensor @ X)",
}
# K6's design (csrc/spmv.cu), which the kernels line names
K6_DESIGN = ("a team of lanes a block row, lanes over X's columns (16-byte "
             "loads where aligned), the thread block's blocks staged in "
             "shared memory, X loaded blocks ahead; bit-equal to one thread "
             "an output summing in block order")
# The cost of a product's scattered x reads alone, beside K5 and K8: one
# index_select of x over the pattern's column indices.  A yardstick, never
# called by the port.
YARDSTICK = {
    "gather_spmv": "torch.index_select(x, 0, indices)",
    "scatter_spmv_part": "torch.index_select(x, 0, indices) over A's "
                         "column indices",
}
# Phase 24: the JAX package on the CPU (f64; tools/homotopy_reference.py
# prints these) — nf / njacs / nsteps, the last λ, max u and Σu of the
# Bratu λ-continuation (u0 = 0, λ from 0 to 6.5, abstol 1e-8; every run
# Success) under each method with a NewtonRaphson inner, and under the
# default HomotopyPolyAlgorithm (its FastShortcut inner); and DynamicSS on
# Bratu 32² at λ = 3.5 (retcode, nf / njacs / nsteps).
JAX_CONTINUATION = {
    32: {"sweep": ([26, 14, 14], 6.5, 1.0023877091495275,
                   473.80664871755164),
         "kantorovich": ([19, 11, 11], 6.5, 1.002387709170672,
                         473.806648725844),
         "arclength": ([86, 62, 62], 6.6349508758050675,
                       1.0023877091707218, 473.8066487258636),
         "polyalg": ([50, 13, 34], 6.5, 1.0023877091495275,
                     473.80664871755164)},
    64: {"sweep": ([26, 14, 14], 6.5, 1.0037901137861862,
                   1840.8359718665906),
         "kantorovich": ([19, 11, 11], 6.5, 1.0037901138065746,
                         1840.8359718975887),
         "arclength": ([86, 62, 62], 6.635817610634698,
                       1.0037901138066256, 1840.8359718976678),
         "polyalg": ([48, 13, 32], 6.5, 1.0037901137861862,
                     1840.8359718665906)},
}
CONTINUATION_SIZES = (32, 64)
# the same three methods at N = 32 at the default abstol (3e-13, the
# rounding floor of the h⁻²-scaled residual): MaxIters in the JAX package,
# near λ 3 and max u 0.27; its nf / njacs / nsteps and last λ, which the
# card's counts may part from (the floor's rounding decides each inner
# solve's last step; ROADMAP C)
JAX_CONTINUATION_FLOOR = {
    "sweep": ("MaxIters", [392, 312, 312], 3.0172801375389096),
    "kantorovich": ("MaxIters", [290, 236, 236], 3.005132231764292),
    "arclength": ("MaxIters", [520, 428, 428], 2.985898174963521)}
JAX_DYNAMIC_SS = {"rosenbrock23": ("Success", [91, 45, 45]),
                  "tsit5": ("MaxIters", [6001, 0, 999])}
# the device time of a continuation run by class: the dense LU of every
# Newton step (cuSOLVER getrf / getrs and the BLAS kernels they call)
# against the rest, chiefly the batched residual of the forward-mode
# Jacobian (elementwise kernels)
CONTINUATION_GROUPS = {
    "getrf/getrs": ("getrf", "getrs", "laswp", "trsm", "trsv", "gemm",
                    "gemv", "iamax", "swap", "ger", "scal", "cusolver",
                    "magma"),
    "jacfwd and residual (elementwise)": ("elementwise", "vectorized",
                                          "unrolled", "pad", "exp"),
    "reductions": ("reduce", "norm", "dot"),
}
# tools/complex_reference.py (the JAX package on the CPU, x64; the script
# prints these): retcode and NLStats [nf, njacs, nfactors, nsolve, nsteps]
# of u³ − 8 from −0.8 + 1.5i under each algorithm (None: the default
# ladder), of the complex least-squares fit under GaussNewton, and of the
# N = 32 Brusselator on a complex128 state (init_u0 + 1e-3·i·z, z seeded
# standard normal, numpy seed 0) under NewtonRaphson at abstol 1e-10.
JAX_COMPLEX = {
    "cubic": {"NewtonRaphson": (1, [7, 5, 5, 5, 5]),
              "Broyden": (1, [10, 0, 0, 8, 8]),
              "Klement": (1, [10, 0, 0, 8, 8]),
              None: (1, [10, 0, 0, 8, 8])},
    "complex_nlls": (1, [3, 1, 1, 1, 1]),
    "complex_brusselator32": (1, [6, 4, 4, 4, 4]),
}
# Phase 26 (a), tools/complex_reference.py likewise: u³ − 8 from
# −0.8 + 1.5i under the engines that order values (SimpleTrustRegion with
# the analytic Jacobian there, its jacfwd refusing complex inputs), and
# the N = 32 complex Brusselator under TrustRegion (its real f64 solve
# takes the same NLStats).  RobustMultiNewton and PseudoTransient fail to
# trace there, and the port refuses them.  The cube is written u·u·u, as
# the JAX package's integer_pow computes it: torch's `u ** 3` on a
# complex CUDA tensor goes through its complex pow and rounds up to
# 1.2e-14 off the product near the root, which the geodesic step of
# LevenbergMarquardt amplifies (ROADMAP C, tools/complex_lm_trace.py).
JAX_ORDERED = {
    "LevenbergMarquardt": (1, [72, 35, 35, 70, 35]),
    "TrustRegion": (6, [35, 33, 33, 33, 33]),
    "AndersonAcceleration": (3, [1002, 0, 0, 0, 1000]),
    "SimpleTrustRegion": (5, [34, 33, 0, 33, 33]),
    "SimpleDFSane": (1, [24, 0, 0, 0, 7]),
    "complex_brusselator32_tr": (1, [6, 4, 4, 4, 4]),
}
# phase 26 (c): bench.py:189-192's refinement operating point
REFINE = {"rounds": 3, "inner_rtol": 1e-2, "restart": 16,
          "krylov_maxiter": 100}
# phase 26 (d): Bratu 128² in f32 (the sparse direct route, abstol 1e-2,
# above the f32 residual's floor of about 4e-3 there) refined by
# auto_refine; the unpreconditioned correction GMRES takes restart 32 and
# 400 iterations a round at this size (the JAX test's 32² takes the
# defaults)
BRATU_REFINE = {"N": 128, "abstol32": 1e-2, "rounds": 4, "restart": 32,
                "krylov_maxiter": 400}
# phase 25 (e): the seeded quadratic system's size (2^n total-degree
# paths) and the seed of its coefficients
# 512 paths, cut from 1024 for time: on the H100 the CPU reference of
# 1024 took 82 s, and the phase waited 34 s for it
POLY_N, POLY_SEED = 9, 0
LOG = {"path": None}


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    if LOG["path"]:
        with open(LOG["path"], "a") as fh:
            fh.write(line + "\n")


def graph_time_ms(torch, fn, calls=50, replays=4):
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between two CUDA events (after one
    warm-up replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def event_time_ms(torch, fn, calls=100):
    """Device time per call of ``fn`` issued eagerly: CUDA events around
    ``calls`` back-to-back calls (after three warm-up calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def profiled_ms(torch, fn, calls=20):
    """Device time per call of ``fn`` issued eagerly: the kernels' own time
    under torch.profiler (every kernel the call launches, summed), so the
    host's launch cost does not count.  For a library call that a CUDA
    graph may not capture."""
    total = sum(k["us_per_call"]
                for k in kernels_per_call(torch, fn, calls).values())
    return total / 1e3 if total > 0 else None


def roofline_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_ms_by_kernel(torch, prof):
    """{kernel name: device ms} of a finished ``torch.profiler.profile``,
    summed over its device events (kernels, copies, sets) as read from the
    profiler's raw events.  ``key_averages()`` sums the same durations but
    first builds a Python event a record, which takes tens of seconds for a
    run of 10⁵ kernels (the lockstep default ladder's 1065 steps)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda or ev.duration_ns() <= 0:
            continue
        out[ev.name()] = out.get(ev.name(), 0.0) + ev.duration_ns() / 1e6
    return out


def device_time_sources_agree(torch, run, card):
    """One profiled ``run()`` read both ways: ``device_ms_by_kernel`` and
    ``key_averages()``'s CUDA events.  Emits both busy times; True when
    they agree within 1e-6 relative."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    raw = sum(device_ms_by_kernel(torch, prof).values())
    t0 = time.perf_counter()
    avg = sum((getattr(ev, "self_device_time_total", 0) or 0) / 1e3
              for ev in prof.key_averages()
              if str(ev.device_type).endswith("CUDA"))
    avg_s = time.perf_counter() - t0
    ok = raw > 0 and abs(raw - avg) <= 1e-6 * avg
    emit({"phase": "device_time_sources", "raw_events_busy_ms": raw,
          "key_averages_busy_ms": avg, "key_averages_s": avg_s, "ok": ok,
          "card": card})
    return ok


def profile_device(torch, run, groups=None, host_events=True):
    """Run ``run()`` once under torch.profiler: its wall time, the device's
    busy time (summed kernel time), the device time by ``groups``
    (DEVICE_GROUPS by default; a kernel goes to the first group one of
    whose substrings its name holds, else to "other") and the top kernels
    by device time.  ``host_events=False`` records the device's kernels
    only (a run of many seconds makes the host's events slow to sort)."""
    groups = DEVICE_GROUPS if groups is None else groups
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host_events:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_ms_by_kernel(torch, prof)
    busy_ms = sum(kernels.values())
    by_group = {}
    for key, ms in kernels.items():
        name = next((g for g, subs in groups.items()
                     if any(sub in key.lower() for sub in subs)), "other")
        by_group[name] = by_group.get(name, 0.0) + ms
    return {"profiled_solve_s": wall,
            "device_ms_by_group": by_group,
            "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
            "device_idle_share": (1.0 - busy_ms / (wall * 1e3)
                                  if busy_ms > 0 else "not measured"),
            "top_device_ms": sorted(kernels.items(),
                                    key=lambda kv: -kv[1])[:12]}


def warm_walls(torch, run, count=3):
    walls = []
    for _ in range(count):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def kernels_per_call(torch, fn, calls=20):
    """The kernels one call of ``fn`` launches, under torch.profiler:
    {kernel name: {"per_call": launches a call, "us_per_call": device µs a
    call}} over ``calls`` eager calls (after three warm-up calls)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0)) or 0
        out[ev.key] = {"per_call": ev.count / calls,
                       "us_per_call": dt / calls}
    return out


def graph_nodes(torch, fn):
    """The launches of one call of ``fn``: the nodes (kernels, memsets,
    copies) it puts in a CUDA graph, counted by ``cuGraphGetNodes``,
    after one call outside the capture."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    count = ctypes.c_size_t(0)
    libcuda = ctypes.CDLL("libcuda.so.1")
    libcuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_size_t)]
    rc = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                None, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed ({rc})")
    return count.value


def sass_counts(so):
    """Machine instructions per kernel of a built library (``cuobjdump
    -sass``, NOPs not counted), by demangled name; {} without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        fn = re.match(r"\s*Function : (\S+)", line)
        if fn:
            name = fn.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line) \
                and " NOP" not in line:
            counts[name] += 1
    filt = shutil.which("c++filt")
    if filt and counts:
        names = subprocess.run([filt], input="\n".join(counts),
                               capture_output=True, text=True).stdout.split("\n")
        counts = dict(zip(names, counts.values()))
    return counts


def brusselator_inputs(torch, brusselator, dev, gen, N, dtype):
    """Phase 3's seeded inputs: U = u0 + 0.1·noise, T noise, the default p;
    made on the host from ``gen`` and moved to ``dev``."""
    U = brusselator.init_u0(N, dtype, device="cpu")
    U = U + 0.1 * torch.randn(U.shape, generator=gen, dtype=dtype)
    T = torch.randn((N, N, 2), generator=gen, dtype=dtype)
    p = brusselator.default_p(N, dtype, device="cpu")
    return U.to(dev), T.to(dev), p.to(dev)


def stencil_timings(torch, stencil, inputs, card):
    """K1, K2 (interleaved and planar, a Python-float and a 0-d tensor
    inv_scale) at f32 and f64, K3 and the bf16 matvec ``mv`` (f32 tangent)
    at N=512 and 2048, and the chain step of the throughput row at N=512
    f32: the time of one wrapper call (CUDA graph), its bound, and the
    kernels the call launches with their device time (torch.profiler).
    Returns {(case, N, dtype): record}."""
    bf = torch.bfloat16
    out = {}
    for N in (512, 2048):
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[-1]
            U, T, p = inputs(N, dtype)
            planes = [U[..., 0].contiguous(), U[..., 1].contiguous(),
                      T[..., 0].contiguous(), T[..., 1].contiguous()]
            inv_t = torch.full((), 0.5, dtype=dtype, device=U.device)
            cases = {
                ("brusselator_jvp", dname):
                    lambda: stencil.brusselator_jvp(U, T, p),
                ("brusselator_jvp_scaled", dname):
                    lambda: stencil.brusselator_jvp_scaled(U, T, p, 0.5),
                ("brusselator_jvp_scaled_tensor_inv", dname):
                    lambda: stencil.brusselator_jvp_scaled(U, T, p, inv_t),
                ("brusselator_jvp_scaled_pair", dname):
                    lambda: stencil.brusselator_jvp_scaled_pair(*planes, p,
                                                                0.5),
                ("brusselator_jvp_scaled_pair_tensor_inv", dname):
                    lambda: stencil.brusselator_jvp_scaled_pair(*planes, p,
                                                                inv_t),
            }
            if dtype == torch.float32:
                Ub, Tb = U.to(bf), T.to(bf)
                mv = stencil.make_brusselator_jvp_bf16(U, p)
                cases[("brusselator_jvp_bf16", "bfloat16")] = (
                    lambda: stencil.brusselator_jvp_bf16(Ub, Tb, p))
                cases[("mv_bf16", "float32")] = lambda: mv(T)
            for (case, cd), fn in cases.items():
                if case == "brusselator_jvp_bf16":
                    # U, T and out once each (2 bytes a value), p in f32
                    bms, by = roofline_ms(
                        3 * N * N * 2 * 2 + 4 * 4,
                        FLOPS_PER_POINT["brusselator_jvp"] * N * N,
                        "bfloat16")
                elif case == "mv_bf16":
                    # U in bf16, T and out in f32, p in f32
                    bms, by = roofline_ms(
                        N * N * 2 * (2 + 4 + 4) + 4 * 4,
                        FLOPS_PER_POINT["brusselator_jvp"] * N * N,
                        "bfloat16")
                else:
                    kname = ("brusselator_jvp" if case == "brusselator_jvp"
                             else "brusselator_jvp_scaled")
                    bms, by = bound_ms(kname, N, dname, U.element_size())
                ms = graph_time_ms(torch, fn)
                rec = {"phase": "stencil_timing", "case": case, "N": N,
                       "dtype": cd, "ms": ms, "bound_ms": bms,
                       "bound_by": by, "share_of_bound": bms / ms,
                       "launches_per_call": graph_nodes(torch, fn),
                       "kernels_per_call": kernels_per_call(torch, fn),
                       "card": card}
                emit(rec)
                out[(case, N, cd)] = rec
            del U, T, p, planes
    # the chain step of bench.py:92-108 (1/s, K2, clamp), N=512 f32
    U, T, p = inputs(512, torch.float32)
    carry = {"c": T.clone(),
             "s": torch.ones((), dtype=torch.float32, device=U.device)}

    def chain_step():
        carry["c"], m = stencil.brusselator_jvp_scaled(U, carry["c"], p,
                                                       1.0 / carry["s"])
        carry["s"] = torch.clamp(m, min=1.0)

    rec = {"phase": "stencil_timing", "case": "chain_step", "N": 512,
           "dtype": "float32",
           "ms": graph_time_ms(torch, chain_step, calls=100, replays=4),
           "launches_per_call": graph_nodes(torch, chain_step),
           "kernels_per_call": kernels_per_call(torch, chain_step),
           "card": card}
    emit(rec)
    out[("chain_step", 512, "float32")] = rec
    return out


def bound_ms(name, N, dtype, itemsize):
    # inputs read once + outputs written once: U and T (or four planes),
    # p, and out (N, N, 2); K2 also reads inv_scale, writes the max
    nbytes = 3 * N * N * 2 * itemsize + 4 * itemsize
    if name == "brusselator_jvp_scaled":
        nbytes += 2 * itemsize
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = FLOPS_PER_POINT[name] * N * N / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rd3d_bound_ms(name, numel, dtype, itemsize):
    # u, t and out once each, D (K10 also inv_scale and the max)
    nbytes = 3 * numel * itemsize + itemsize
    if name == "rd3d_jvp_scaled":
        nbytes += 2 * itemsize
    return roofline_ms(nbytes, FLOPS_PER_POINT[name] * numel, dtype)


DESIGNS_3D = "nonlinearsolve_tpu_torch/bench/rd3d_designs.cu"


def build_rd3d_designs(_backend):
    """nvcc of ``bench/rd3d_designs.cu`` (K9-K11's first design, one thread
    a column) with the package's flags, into the package's build
    directory."""
    from pathlib import Path
    here = Path(os.path.dirname(os.path.abspath(__file__)))
    return _backend.compile_shared(here / DESIGNS_3D, "rd3d_designs", "nvcc",
                                   _backend._find_nvcc(), _backend.NVCC_FLAGS)


class ColumnRd3d:
    """K9-K11's first design, called on the wrappers' own arguments
    (``ops/stencil3d.py`` ``_scalar_args``, the periodic halo planes) and
    counted nowhere: the yardstick the redesign is held to bit for bit and
    timed beside."""

    def __init__(self, torch, _backend, stencil3d, so):
        import ctypes
        self.torch, self._backend, self.s3 = torch, _backend, stencil3d
        self.lib = ctypes.CDLL(str(so))
        for name, argtypes in stencil3d._SIGNATURES.items():
            fn = getattr(self.lib, "column_" + name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def _check(self, rc, what):
        if rc != 0:
            raise RuntimeError(f"column {what}: CUDA launch failed ({rc})")

    def jvp(self, u, t, D, bz, lo=None, hi=None, n_global=None):
        """K9 (``lo``/``hi`` None: the periodic planes) or K11."""
        b, s3 = self._backend, self.s3
        dtype, shape, d, h2 = s3._scalar_args(u, t, D, n_global)
        if lo is None:
            lo, hi = s3._halo_planes(t, shape)
        out = self.torch.empty_like(u)
        rc = getattr(self.lib, f"column_rd3d_jvp_{s3._SUFFIX[dtype]}")(
            b.ptr(u), b.ptr(t), b.ptr(lo), b.ptr(hi), b.ptr(d), h2,
            b.ptr(out), shape[0], shape[1], shape[2], bz,
            b.stream_handle(u))
        self._check(rc, "rd3d_jvp")
        return out

    def scaled(self, u, t, D, inv_scale, bz):
        """K10."""
        from nonlinearsolve_tpu_torch.ops.stencil import _inv_scale_tensor
        b, s3 = self._backend, self.s3
        dtype, shape, d, h2 = s3._scalar_args(u, t, D)
        inv = _inv_scale_tensor(inv_scale, dtype, u.device)
        lo, hi = s3._halo_planes(t, shape)
        out = self.torch.empty_like(u)
        mx = self.torch.zeros((), dtype=dtype, device=u.device)
        rc = getattr(self.lib, f"column_rd3d_jvp_scaled_{s3._SUFFIX[dtype]}")(
            b.ptr(u), b.ptr(t), b.ptr(lo), b.ptr(hi), b.ptr(d), h2,
            b.ptr(inv), b.ptr(out), b.ptr(mx), shape[0], shape[1], shape[2],
            bz, b.stream_handle(u))
        self._check(rc, "rd3d_jvp_scaled")
        return out, mx


def side_by_side_ms(torch, new, old, **kw):
    """CUDA-event times of ``new`` and ``old`` in turns (new, old, old,
    new), each ``graph_time_ms``: ([new readings], [old readings])."""
    a = [graph_time_ms(torch, new, **kw)]
    b = [graph_time_ms(torch, old, **kw)]
    b.append(graph_time_ms(torch, old, **kw))
    a.append(graph_time_ms(torch, new, **kw))
    return a, b


def bit_equal(torch, a, b):
    """Equal bit for bit (so -0 is not +0); a NaN matches any NaN."""
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.float64: torch.int64}
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        a.view(ints[a.dtype])[~na], b.view(ints[b.dtype])[~nb]))


def k3_kernel_checks(torch, stencil, inputs, timings):
    """K3 against its plain version on the card, bit for bit, at N=512 and
    2048 (bf16 state and tangent from phase 3's seeded f32 inputs, f32 p),
    and the bf16 matvec ``mv(T)`` on the f32 tangent (one launch of K3's f32
    variant) against cast -> K3's plain version -> cast, bit for bit.  The
    times are ``stencil_timings``'s; the plain version is timed here at
    N=512.  Returns the records by N."""
    bf = torch.bfloat16
    summary = {}
    for N in (512, 2048):
        U, T, p = inputs(N, torch.float32)
        Ub, Tb = U.to(bf), T.to(bf)
        got = stencil.brusselator_jvp_bf16(Ub, Tb, p)
        ref = stencil.brusselator_jvp_bf16_plain(Ub, Tb, p)
        mv = stencil.make_brusselator_jvp_bf16(U, p)
        mv_got = mv(T)
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, ref)
        differing = int((got.view(torch.int16) != ref.view(torch.int16)).sum())
        mv_equal = bit_equal(torch, mv_got, ref.float())
        t = timings[("brusselator_jvp_bf16", N, "bfloat16")]
        t_mv = timings[("mv_bf16", N, "float32")]
        rec = {"phase": "kernel_check", "case": "brusselator_jvp_bf16",
               "N": N, "dtype": "bfloat16", "bit_equal": differing == 0,
               "differing_values": differing, "max_abs_err": abs_err,
               "rel_err": rel, "mv_bit_equal": mv_equal,
               "ms": t["ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"],
               "share_of_bound": t["share_of_bound"],
               "mv_ms": t_mv["ms"], "mv_bound_ms": t_mv["bound_ms"],
               "mv_share_of_bound": t_mv["share_of_bound"],
               "k1_f32_ms": timings[("brusselator_jvp", N, "float32")]["ms"],
               "ok": differing == 0 and mv_equal}
        if N == 512:
            rec["plain_ms"] = graph_time_ms(
                torch, lambda: stencil.brusselator_jvp_bf16_plain(Ub, Tb, p),
                calls=10, replays=20)
        summary[N] = rec
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"K3 N={N} (or its f32 variant) is not "
                                 f"bit-equal to its plain version: {rec}")
        del U, T, p, Ub, Tb, got, ref, mv_got
    return summary


def k2_graph_replay_checks(torch, stencil, inputs, replays=200):
    """K2 captured in a CUDA graph (both layouts, f32 and f64, N=512, a 0-d
    tensor inv_scale), replayed ``replays`` times with a new inv_scale each
    time: every replay's max must equal max|out| of its own output exactly
    (the max's word is zeroed in the graph too), and the last replay's out
    and max must match the plain version at TOL."""
    import numpy as np
    rng = np.random.default_rng(5)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        U, T, p = inputs(512, dtype)
        planes = [x[..., k].contiguous() for x in (U, T) for k in (0, 1)]
        inv = torch.ones((), dtype=dtype, device=U.device)
        calls = {
            "interleaved": lambda: stencil.brusselator_jvp_scaled(U, T, p,
                                                                  inv),
            "planar": lambda: stencil.brusselator_jvp_scaled_pair(
                *planes, p, inv)}
        for layout, fn in calls.items():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                res = fn()
            out = res[0] if layout == "interleaved" else torch.stack(
                res[:2], -1)
            mx = res[-1]
            exact = 0
            for _ in range(replays):
                s = float(rng.uniform(0.1, 4.0))
                inv.fill_(s)
                graph.replay()
                if layout == "planar":
                    out = torch.stack(res[:2], -1)
                exact += bool(torch.equal(mx, out.abs().max()))
            ref, mx_ref = stencil.brusselator_jvp_scaled_plain(U, T, p, s)
            err = rel_err(out, ref)[1]
            mx_err = rel_err(mx, mx_ref)[1]
            rec = {"phase": "kernel_check_k2_graph", "layout": layout,
                   "N": 512, "dtype": dname, "replays": replays,
                   "max_exact_replays": exact, "rel_err": err,
                   "absmax_rel_err": mx_err, "tolerance": TOL[dname],
                   "ok": exact == replays and err <= TOL[dname]
                   and mx_err <= TOL[dname]}
            emit(rec)
            if not rec["ok"]:
                raise AssertionError(f"K2 under graph replay: {rec}")
            del graph
        del U, T, p, planes
    k2_side_by_side_check(torch, stencil, inputs, rng)


def k2_side_by_side_check(torch, stencil, inputs, rng, replays=100):
    """Two CUDA graphs of K2 (N=512 f32, two tangents, a 0-d tensor
    inv_scale each), captured on PyTorch's one capture stream and replayed
    side by side on two streams ``replays`` times with new inv_scales: each
    replay's max must equal max|out| of its own output exactly (launches
    share no state), and the last replay's out must match the plain
    version at TOL."""
    U, T, p = inputs(512, torch.float32)
    tangents = [T, torch.flip(T, (0,)).contiguous()]
    invs = [torch.ones((), dtype=torch.float32, device=U.device)
            for _ in tangents]
    graphs, results = [], []
    for Tk, inv in zip(tangents, invs):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            stencil.brusselator_jvp_scaled(U, Tk, p, inv)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            results.append(stencil.brusselator_jvp_scaled(U, Tk, p, inv))
        graphs.append(graph)
    streams = [torch.cuda.Stream() for _ in graphs]
    exact = 0
    scales = [1.0, 1.0]
    for _ in range(replays):
        scales = [float(rng.uniform(0.1, 4.0)) for _ in graphs]
        for inv, sc in zip(invs, scales):
            inv.fill_(sc)
        torch.cuda.synchronize()
        for graph, st in zip(graphs, streams):
            with torch.cuda.stream(st):
                graph.replay()
        torch.cuda.synchronize()
        exact += all(bool(torch.equal(mx, out.abs().max()))
                     for out, mx in results)
    err = max(rel_err(out, stencil.brusselator_jvp_scaled_plain(
        U, Tk, p, sc)[0])[1] for (out, _), Tk, sc in zip(results, tangents,
                                                          scales))
    rec = {"phase": "kernel_check_k2_side_by_side", "N": 512,
           "dtype": "float32", "graphs": len(graphs), "replays": replays,
           "max_exact_replays": exact, "rel_err": err,
           "tolerance": TOL["float32"],
           "ok": exact == replays and err <= TOL["float32"]}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"K2 graphs side by side: {rec}")


def k11_kernel_checks(torch, dev, stencil3d, column):
    """K11 on z-slabs at 256³ (S = 4 and 8 slabs, bz 8) and on (40, 72,
    100) (S = 4, bz 5), f32 and f64: each slab given its neighbours' planes
    and h of the whole grid; the slabs together must be bit-equal to K9 on
    the whole grid, and each slab to the first design (``column``) on the
    same slab.  Then K11 against its plain version (TOL) and bit for bit
    against the first design, f32 and f64, on a 64-plane shard of the 256³
    grid and on the whole 256³ grid as one shard (the weak-scaling report's
    shard at world size 1; there also bit-equal to K9), and timed at f32
    on both, the first design beside it in the same call.  Returns the f32
    timing records by shard."""
    gen = torch.Generator(device=dev).manual_seed(4)
    records = {}
    for shape, slabs, bz in (((256, 256, 256), (4, 8), 8),
                             ((40, 72, 100), (4,), 5)):
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[-1]
            u = 0.1 + 0.5 * torch.randn(shape, generator=gen, dtype=dtype,
                                        device=dev)
            t = torch.randn(shape, generator=gen, dtype=dtype, device=dev)
            D = torch.tensor(0.01, dtype=dtype, device=dev)
            whole = stencil3d.rd3d_jvp_blocked(u, t, D, bz=bz)
            equal, first = {}, {}
            for S in slabs:
                nz = shape[0] // S
                parts, same = [], True
                for s in range(S):
                    z = slice(s * nz, (s + 1) * nz)
                    lo = t[(s * nz - 1) % shape[0]][None].contiguous()
                    hi = t[((s + 1) * nz) % shape[0]][None].contiguous()
                    us, ts = u[z].contiguous(), t[z].contiguous()
                    parts.append(stencil3d.rd3d_jvp_blocked_halo(
                        us, ts, lo, hi, D, bz=bz, n_global=shape[0]))
                    same = same and bit_equal(torch, parts[-1], column.jvp(
                        us, ts, D, bz, lo, hi, shape[0]))
                equal[f"S={S}"] = bool(torch.equal(torch.cat(parts), whole))
                first[f"S={S}"] = same
                del parts
            rec = {"phase": "kernel_check_k11_shards", "shape": list(shape),
                   "dtype": dname, "bz": bz, "bit_equal_to_k9": equal,
                   "bit_equal_to_first_design": first,
                   "ok": all(equal.values()) and all(first.values())}
            if shape[0] == 256:
                # K11 against its plain version on a 64-plane shard (given
                # its neighbours' planes) and on the whole grid as one shard
                # (given its own wrapped planes, as the weak-scaling report's
                # shard at world size 1 is; that one is also K9's input, so
                # it must be bit-equal to K9)
                cases = {"shard_64": (u[:64].contiguous(), t[:64].contiguous(),
                                      t[-1:].contiguous(),
                                      t[64:65].contiguous()),
                         "whole_256": (u, t, t[-1:].contiguous(),
                                       t[:1].contiguous())}
                rec["vs_plain"] = {}
                for name, (a, b, la, hb) in cases.items():
                    got = stencil3d.rd3d_jvp_blocked_halo(a, b, la, hb, D,
                                                          bz=8, n_global=256)
                    ref = stencil3d.rd3d_jvp_blocked_halo_plain(a, b, la, hb,
                                                                D, 256)
                    torch.cuda.synchronize()
                    abs_err, rel = rel_err(got, ref)
                    check = {"shape": list(a.shape), "max_abs_err": abs_err,
                             "rel_err": rel, "tolerance": TOL[dname],
                             "bit_equal_to_first_design": bit_equal(
                                 torch, got, column.jvp(a, b, D, 8, la, hb,
                                                        256))}
                    check["ok"] = (rel <= TOL[dname]
                                   and check["bit_equal_to_first_design"])
                    if name == "whole_256":
                        check["bit_equal_to_k9"] = bool(torch.equal(got,
                                                                    whole))
                        check["ok"] = check["ok"] and check["bit_equal_to_k9"]
                    rec["vs_plain"][name] = check
                    rec["ok"] = rec["ok"] and check["ok"]
                    del got, ref
                    if dtype != torch.float32:
                        continue
                    ms_new, ms_first = side_by_side_ms(
                        torch, lambda: stencil3d.rd3d_jvp_blocked_halo(
                            a, b, la, hb, D, bz=8, n_global=256),
                        lambda: column.jvp(a, b, D, 8, la, hb, 256))
                    ms = sum(ms_new) / 2
                    plain_ms = graph_time_ms(
                        torch, lambda: stencil3d.rd3d_jvp_blocked_halo_plain(
                            a, b, la, hb, D, 256), calls=5, replays=10)
                    plane = shape[1] * shape[2]
                    bms, by = roofline_ms(
                        (3 * a.numel() + 2 * plane + 1) * u.element_size(),
                        FLOPS_PER_POINT["rd3d_jvp"] * a.numel(), dname)
                    records[name] = {
                        "phase": "kernel_time_k11", "case": name,
                        "shape": list(a.shape), "dtype": dname,
                        "max_abs_err": abs_err, "ms": ms,
                        "ms_readings": ms_new,
                        "first_design_ms_readings": ms_first,
                        "first_design_share_of_bound":
                            bms / (sum(ms_first) / 2),
                        "plain_ms": plain_ms, "bound_ms": bms,
                        "bound_by": by, "share_of_bound": bms / ms}
                    emit(records[name])
                del cases, a, b, la, hb
            emit(rec)
            if not rec["ok"]:
                raise AssertionError(f"K11 {shape} {dname}: {rec}")
            del u, t, whole
    return records


def rel_err(got, ref):
    err = float((got.double() - ref.double()).abs().max())
    scale = max(float(ref.double().abs().max()), 1.0)
    return err, err / scale


def flat(torch, out):
    """A kernel's output, or a list of them (one a part) end to end."""
    return torch.cat(out) if isinstance(out, list) else out


def spmv_case(torch, name, tables, dname, kern, plain, library, cost, shape,
              exact=False, extra_check=None, yardstick=None):
    """One SpMV case: the kernel (or a list of launches, one a part, whose
    outputs are compared end to end) against its plain version (bit for
    bit when ``exact``, else at TOL), then its times, its bound from
    ``cost`` = (bytes, flops), the library call's time and, where given,
    the ``yardstick`` call's (YARDSTICK).  Emits and returns the record;
    raises if the kernel disagrees."""
    got, ref = flat(torch, kern()), flat(torch, plain())
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, ref)
    ok = bool(torch.equal(got, ref)) if exact else rel <= TOL[dname]
    extra = extra_check(got) if extra_check else {}
    ok = ok and all(extra.values())
    # the library call is a yardstick, not a check: a refusal is
    # recorded, not raised
    try:
        lib_err = rel_err(flat(torch, library()), ref)[1]
        library_ms = profiled_ms(torch, library)
        library_eager = event_time_ms(torch, library)
    except RuntimeError as exc:
        lib_err = f"refused: {exc}"[:300]
        library_ms = library_eager = None
    ms = graph_time_ms(torch, kern)
    ms_profiled = profiled_ms(torch, kern)
    ms_eager = event_time_ms(torch, kern)
    plain_ms = graph_time_ms(torch, plain, calls=10, replays=20)
    bms, by = roofline_ms(cost[0], cost[1], dname)
    if yardstick is not None:
        extra["index_select_ms"] = graph_time_ms(torch, yardstick)
        extra["index_select"] = YARDSTICK[name]
    rec = {"phase": "kernel_check", "case": name, "tables": tables,
           "dtype": dname, "shape": shape, "max_abs_err": abs_err,
           "rel_err": rel, "tolerance": 0.0 if exact else TOL[dname],
           "ms": ms, "ms_profiled": ms_profiled, "ms_eager_events": ms_eager,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_ms_eager_events": library_eager,
           "library": SPMV_LIBRARY[name], "library_rel_err": lib_err,
           "bound_ms": bms, "bound_by": by, "bound_bytes": cost[0],
           "share_of_bound": bms / ms, "ok": ok, **extra}
    emit(rec)
    if not ok:
        raise AssertionError(f"{name} {dname} disagrees with its plain "
                             f"version: {rec}")
    return rec


def k5_case(torch, spmv, tables, dname, indptr, indices, data, x, shape):
    """K5 on one CSR (``shape`` = rows, columns) against its plain version
    at TOL, a second launch bit-equal to the first, timed beside cuSPARSE
    and the index_select yardstick.  The byte bound reads each column of x
    that the table names once (all of x for a square Jacobian, fewer for a
    device-LU stage)."""
    n_rows, n_cols = shape
    nnz = indices.shape[0]
    item = data.element_size()
    cols_read = int(torch.unique(indices).numel())
    csr_lib = torch.sparse_csr_tensor(indptr, indices, data, shape)

    def twice(got):
        again = spmv.gather_spmv(indptr, indices, data, x)
        torch.cuda.synchronize()
        return {"two_launches_equal": bool(torch.equal(again, got))}

    return spmv_case(
        torch, "gather_spmv", tables, dname,
        lambda: spmv.gather_spmv(indptr, indices, data, x),
        lambda: spmv.gather_spmv_plain(indptr, indices, data, x),
        lambda: csr_lib @ x,
        (nnz * (item + 4) + (n_rows + 1) * 4 + (n_rows + cols_read) * item,
         2 * nnz), [n_rows, n_cols, nnz], extra_check=twice,
        yardstick=lambda: torch.index_select(x, 0, indices))


def selection_case(torch, spmv, sel, tables, dtype, dev, rng):
    """K5's unit-data variant on a static selection's own table, with
    seeded values (every pad slot must come out 0)."""
    import numpy as np
    dname = str(dtype).split(".")[-1]
    item = torch.finfo(dtype).bits // 8
    src = sel.table(dev)
    src_long = src.long()
    n_read = int(np.count_nonzero(sel.src < sel.n_src))
    values = torch.as_tensor(rng.standard_normal(sel.n_src), dtype=dtype,
                             device=dev)
    values_ext = torch.cat([values, values.new_zeros(1)])
    return spmv_case(
        torch, "gather_select", tables, dname,
        lambda: spmv.gather_select(src, values),
        lambda: spmv.gather_select_plain(src, values),
        lambda: torch.take(values_ext, src_long),
        (sel.n_out * 4 + n_read * item + sel.n_out * item, 0),
        [sel.n_out, sel.n_src], exact=True)


def sparse_kernel_checks(torch, dev, spmv, brusselator, plan_sparse):
    """K4 and K5's selection on the 512² Brusselator's own tables (the DIA
    route's: the assembly-direct selection and the 11 diagonals), seeded
    data, f32 and f64, against their plain versions.  Returns the f64
    records by kernel."""
    import numpy as np

    N = 512
    n = 2 * N * N
    pat = brusselator.sparsity_pattern(N)
    plan = plan_sparse(None, n, n, sparsity=pat)
    dplan = plan.dia_plan
    indptr, indices = pat.device_tables(dev)
    in_band = sum(n - abs(o) for o in dplan.offsets)
    out_band = torch.zeros((dplan.ndiag, n), dtype=torch.bool)
    for d, off in enumerate(dplan.offsets):
        if off > 0:
            out_band[d, n - off:] = True
        elif off < 0:
            out_band[d, :-off] = True
    out_band = out_band.to(dev)
    rng = np.random.default_rng(0)
    records = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        item = torch.finfo(dtype).bits // 8
        sel_rec = selection_case(torch, spmv, plan.dia_selection,
                                 "dia_assembly_512", dtype, dev, rng)
        data = torch.as_tensor(rng.standard_normal(pat.nnz), dtype=dtype,
                               device=dev)
        x = torch.as_tensor(rng.standard_normal(n), dtype=dtype, device=dev)
        dd = dplan.pack(data)
        csr_lib = torch.sparse_csr_tensor(indptr, indices, data, (n, n))
        dd_inf = dd.clone()
        dd_inf[out_band] = float("inf")

        def inf_pads(got):
            # inf in every out-of-band slot: K4 must not read them
            y_inf = spmv.dia_spmv(dd_inf, dplan.offsets, x)
            torch.cuda.synchronize()
            return {"inf_pads_finite": bool(torch.isfinite(y_inf).all()),
                    "inf_pads_equal": bool(torch.equal(y_inf, got))}

        dia_rec = spmv_case(
            torch, "dia_spmv", "dia_512", dname,
            lambda: spmv.dia_spmv(dd, dplan.offsets, x),
            lambda: spmv.dia_spmv_plain(dd, dplan.offsets, x),
            lambda: csr_lib @ x,
            (in_band * item + 2 * n * item, 2 * in_band), [dplan.ndiag, n],
            extra_check=inf_pads)
        if dtype == torch.float64:
            records = {"gather_select": sel_rec, "dia_spmv": dia_rec}
        del data, x, dd, dd_inf, csr_lib
    return records


def csr_kernel_checks(torch, dev, spmv, cplan, jac_data):
    """K5 on the CSR route's own tables (the permuted pattern, its
    assembled Jacobian as data, a seeded x) and its selection on that
    route's assembly table, f32 and f64.  Returns the f64 records."""
    import numpy as np

    pat = cplan.pattern
    n = pat.shape[0]
    indptr, indices = pat.device_tables(dev)
    rng = np.random.default_rng(1)
    x64 = torch.as_tensor(rng.standard_normal(n), device=dev)
    records = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        data = jac_data.to(dtype).contiguous()
        x = x64.to(dtype)
        rec = k5_case(torch, spmv, "csr_route_512_permuted", dname, indptr,
                      indices, data, x, (n, n))
        sel_rec = selection_case(torch, spmv, cplan._select,
                                 "csr_assembly_512_permuted", dtype, dev,
                                 rng)
        if dtype == torch.float64:
            records = {"gather_spmv": rec, "gather_select_csr": sel_rec}
        del data, x
    return records


def reverse_rule_check(torch, _backend, spmv, name, tables, pattern,
                       jac_data):
    """Phase 23 (c): the reverse rule of ``name`` (K5, K7 or K8) on a
    route's own matrix (``pattern``'s tier and plan, ``jac_data`` as its
    data).  ȳ = w and the gradient of ⟨w, A·x⟩ w.r.t. the data and x
    through ``CSR.matvec`` (x̄ by the kernel on Aᵀ's tables), the launches
    of the backward counted, against autograd through the plain CSR
    product on the card: d̄ata bit for bit (the same products), x̄ within
    rel-inf VJP_TOL (the plain version adds by atomics).  Timed: the
    backward, and its x̄ launches alone, by CUDA events; their byte bound;
    cuSPARSE's Aᵀ·ȳ.  Emits and returns the record; raises on a
    disagreement."""
    import numpy as np
    dev = jac_data.device
    dtype = jac_data.dtype
    dname = str(dtype).split(".")[-1]
    item = jac_data.element_size()
    n_rows, n_cols = pattern.shape
    nnz = pattern.nnz
    g = np.random.default_rng(23)
    w = torch.as_tensor(g.standard_normal(n_rows), dtype=dtype, device=dev)
    x = torch.as_tensor(g.standard_normal(n_cols), dtype=dtype, device=dev)
    C = pattern.with_data(jac_data)
    route, reordered = spmv.csr_route(C)
    t0 = time.perf_counter()
    troute, _tperm = route.transpose()
    tperm = route.tperm(dev)
    transpose_s = time.perf_counter() - t0
    data = jac_data.detach().clone().requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    y = C.with_data(data).matvec(xr)
    loss = (w * y).sum()
    torch.cuda.synchronize()
    before = dict(_backend.LAUNCHES)
    gd, gx = torch.autograd.grad(loss, (data, xr), retain_graph=True)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in _backend.LAUNCHES.items()
                if v != before[k]}
    indptr, indices = pattern.device_tables(dev)
    data_p = jac_data.detach().clone().requires_grad_(True)
    x_p = x.clone().requires_grad_(True)
    y_p = spmv.gather_spmv_plain(indptr, indices, data_p, x_p)
    gd_p, gx_p = torch.autograd.grad((w * y_p).sum(), (data_p, x_p))
    del y_p, data_p, x_p
    dbar_equal = bool(torch.equal(gd, gd_p))
    xbar_abs, xbar_rel = rel_err(gx, gx_p)
    xbar_equal = bool(torch.equal(gx, gx_p))
    del gd_p, gx_p
    # x̄'s launches alone: the kernel on Aᵀ's tables with the permuted data
    tdata = jac_data.index_select(0, tperm)
    if troute.kind == "gather":
        tptr, tidx = troute.pattern.device_tables(dev)
        xbar = lambda: spmv.gather_spmv(tptr, tidx, tdata, w)  # noqa: E731
        nbytes = nnz * (item + 4) + (n_cols + 1) * 4 + (n_rows + n_cols) * item
    elif troute.kind == "stream":
        from nonlinearsolve_tpu_torch.ops import spmv_stream
        packed = troute.plan.pack_data(tdata)
        cols = troute.plan.cols_table(dev)
        xbar = lambda: spmv_stream.band_spmv_packed(  # noqa: E731
            cols, packed, w, n_cols)
        nbytes = cols.numel() * 4 + nnz * item + (n_rows + n_cols) * item
    elif troute.kind == "scatter":
        staged = troute.plan.stage(tdata)
        parts = troute.plan.tables(dev)
        xbar = lambda: troute.plan.apply_staged(staged, w)  # noqa: E731
        nbytes = n_cols * item + sum(
            t.gcol.shape[0] * (4 + item) + t.pos.shape[0] * 4
            + (t.rptr.shape[0] + t.zstart.shape[0]) * 4
            + (t.c1 - t.c0) * item for t in parts)
    else:
        raise AssertionError(f"{name}: Aᵀ took the {troute.kind} route")
    xbar_direct_equal = bool(torch.equal(xbar(), gx))
    tptr, tidx = troute.pattern.device_tables(dev)
    lib_t = torch.sparse_csr_tensor(tptr, tidx, tdata, (n_cols, n_rows))
    library_ms = profiled_ms(torch, lambda: lib_t @ w)
    library_rel = rel_err(lib_t @ w, gx)[1]
    ms = graph_time_ms(torch, xbar)
    bms, by = roofline_ms(nbytes, 2 * nnz, dname)
    backward_ms = event_time_ms(
        torch, lambda: torch.autograd.grad(loss, (data, xr),
                                           retain_graph=True), calls=10)
    kernel_launches = launches.get(name, 0)
    expect = (len(troute.plan.parts) if troute.kind == "scatter" else 1)
    rec = {"phase": "reverse_rule", "kernel": name, "tables": tables,
           "dtype": dname, "shape": [n_rows, n_cols, nnz],
           "route": route.kind, "reordered": reordered,
           "transpose_route": troute.kind,
           "transpose_reuses_forward_plan": troute.plan is route.plan
           and route.plan is not None,
           "transpose_host_s": transpose_s,
           "launches_per_backward": launches,
           "dbar_bit_equal_to_plain": dbar_equal,
           "xbar_bit_equal_to_plain": xbar_equal,
           "xbar_max_abs_err": xbar_abs, "xbar_rel_err": xbar_rel,
           "xbar_tolerance": VJP_TOL[dname],
           "xbar_equals_its_launches_alone": xbar_direct_equal,
           "backward_ms": backward_ms, "xbar_ms": ms,
           "xbar_bound_ms": bms, "xbar_bound_by": by,
           "xbar_bound_bytes": nbytes, "xbar_share_of_bound": bms / ms,
           "library_ms": library_ms, "library": "cuSPARSE CSR matvec of "
           "Aᵀ (torch.sparse_csr_tensor of the transposed tables @ ȳ)",
           "library_rel_err": library_rel}
    checks = {
        "d̄ata bit for bit": dbar_equal,
        "x̄ within tolerance": xbar_rel <= VJP_TOL[dname],
        "x̄ is the kernel's on Aᵀ": xbar_direct_equal,
        f"{name} launched by the backward": kernel_launches == expect,
    }
    rec["ok"] = all(checks.values())
    emit(rec)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"reverse rule of {name} failed: {failed}")
    del gd, gx, tdata, lib_t, loss, y, data, xr
    return rec


def bsr_kernel_checks(torch, dev, spmv, Jb):
    """K6 against its plain version on the block-sparse phase's matrix (the
    512² Jacobian at the root, b = 2) with seeded X, nrhs 8 and 37, f32 and
    f64; timed beside cuSPARSE (BSR × dense, or CSR × dense on the expanded
    pattern where torch refuses BSR) and beside K5 on the expanded pattern
    once per column, and K5's index_select yardstick there.  Returns the
    records by (dtype, nrhs)."""
    import numpy as np

    n = Jb.shape[0]
    b = Jb.blocksize
    nblocks = len(Jb.indices)
    indptr, indices, _cols, _brow = Jb.device_tables(dev)
    s_indptr, s_indices, take = Jb.scalar_tables(dev)
    rng = np.random.default_rng(6)
    records = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        item = torch.finfo(dtype).bits // 8
        A = Jb.with_data(Jb.data.to(dtype).contiguous())
        s_data = A.data.reshape(-1)[take]
        bsr_lib = torch.sparse_bsr_tensor(indptr, indices, A.data, (n, n))
        csr_lib = torch.sparse_csr_tensor(s_indptr, s_indices, s_data, (n, n))
        for nrhs in (8, 37):
            X = torch.as_tensor(rng.standard_normal((n, nrhs)), dtype=dtype,
                                device=dev)
            Xt = X.t().contiguous()
            try:
                (bsr_lib @ X).sum().item()
                library, refusal = (lambda: bsr_lib @ X), None
            except RuntimeError as exc:
                library = lambda: csr_lib @ X
                refusal = f"torch.sparse_bsr_tensor @ X refused: {exc}"[:300]

            def k5_columns():
                return [spmv.gather_spmv(s_indptr, s_indices, s_data, Xt[c])
                        for c in range(nrhs)]

            def extra(got):
                return {"k5_columns_equal_plain": rel_err(
                    torch.stack(k5_columns(), 1), got)[1] <= TOL[dname]}

            rec = spmv_case(
                torch, "bsr_spmm", "bsr_512_root_b2", dname,
                lambda: spmv.bsr_spmm(A, X),
                lambda: spmv.bsr_spmm_plain(A, X), library,
                (nblocks * (b * b * item + 4) + (n // b + 1) * 4
                 + 2 * n * nrhs * item, 2 * nblocks * b * b * nrhs),
                [n, nrhs, nblocks, b], extra_check=extra)
            def k5_yardstick():
                return [torch.index_select(Xt[c], 0, s_indices)
                        for c in range(nrhs)]

            plan = spmv.bsr_spmm_plan(b, nrhs, item, X.data_ptr())
            rec = {**rec, "nrhs": nrhs, "plan": plan._asdict(),
                   "stage_blocks": spmv.bsr_stage_blocks(
                       Jb.indptr, b, item, plan.team_shift),
                   "library_call": ("bsr" if refusal is None
                                    else "csr_expanded"),
                   "library_refusal": refusal,
                   "k5_columns_ms": graph_time_ms(torch, k5_columns,
                                                  calls=10, replays=4),
                   "k5_columns_index_select_ms": graph_time_ms(
                       torch, k5_yardstick, calls=10, replays=4)}
            emit({"phase": "kernel_time_bsr", "dtype": dname, "nrhs": nrhs,
                  "plan": rec["plan"], "stage_blocks": rec["stage_blocks"],
                  "library_call": rec["library_call"],
                  "library_refusal": refusal,
                  "k5_columns_ms": rec["k5_columns_ms"],
                  "k5_columns_index_select_ms":
                      rec["k5_columns_index_select_ms"]})
            records[(dname, nrhs)] = rec
            del X, Xt
        del A, s_data, bsr_lib, csr_lib
    return records


def rd3d_kernel_checks(torch, dev, stencil3d, column):
    """K9 and K10 against their plain versions at RD3D_SHAPES, f32 and f64,
    every bz / double_buffer the wrappers take on the 3D paths, and a NaN
    in the tangent; and bit for bit against their first design
    (``column``, ``bench/rd3d_designs.cu``) at each bz, K10's max too.  The
    256³ cases timed, the first design beside them in the same call.
    Returns the 256³ f32 records by kernel."""
    gen = torch.Generator(device=dev).manual_seed(3)
    summary = {}
    for shape in RD3D_SHAPES:
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[-1]
            u = 0.1 + 0.5 * torch.randn(shape, generator=gen, dtype=dtype,
                                        device=dev)
            t = torch.randn(shape, generator=gen, dtype=dtype, device=dev)
            D = torch.tensor(0.01, dtype=dtype, device=dev)
            inv = torch.tensor(0.5, dtype=dtype, device=dev)
            ref = stencil3d.rd3d_jvp_blocked_plain(u, t, D)
            ref_s, m_ref = stencil3d.rd3d_jvp_scaled_plain(u, t, D, inv)
            errs, same = {}, {}
            for bz in (4, 8):
                for db in (False, True):
                    got = stencil3d.rd3d_jvp_blocked(u, t, D, bz=bz,
                                                     double_buffer=db)
                    errs[f"rd3d_jvp bz={bz} db={db}"] = rel_err(got, ref)
                    same[f"rd3d_jvp bz={bz} db={db}"] = bit_equal(
                        torch, got, column.jvp(u, t, D, bz))
                out, m = stencil3d.rd3d_jvp_scaled(u, t, D, inv, bz=bz)
                errs[f"rd3d_jvp_scaled bz={bz}"] = rel_err(out, ref_s)
                errs[f"rd3d_jvp_scaled bz={bz} absmax"] = rel_err(m, m_ref)
                out_c, m_c = column.scaled(u, t, D, inv, bz)
                same[f"rd3d_jvp_scaled bz={bz}"] = (
                    bit_equal(torch, out, out_c) and bit_equal(torch, m, m_c))
                del got, out, out_c
            tn = t.clone()
            tn[shape[0] // 2, 7, 11] = float("nan")
            m_nan = stencil3d.rd3d_jvp_scaled(u, tn, D, inv, bz=4)[1]
            torch.cuda.synchronize()
            nan_ok = bool(torch.isnan(m_nan))
            ok = (nan_ok and all(e[1] <= TOL[dname] for e in errs.values())
                  and all(same.values()))
            rec = {"phase": "kernel_check_3d", "shape": list(shape),
                   "dtype": dname, "tolerance": TOL[dname],
                   "rel_err": {k: e[1] for k, e in errs.items()},
                   "max_abs_err": max(e[0] for e in errs.values()),
                   "bit_equal_to_first_design": same,
                   "nan_absmax": float(m_nan), "ok": ok}
            emit(rec)
            if not ok:
                raise AssertionError(f"K9/K10 {shape} {dname} disagree with "
                                     f"their plain versions or their first "
                                     f"design: {rec}")
            if shape != RD3D_SHAPES[0]:
                continue
            cases = {
                "rd3d_jvp": (
                    "bz=4 double_buffer=True (the 3D solve's)",
                    lambda: stencil3d.rd3d_jvp_blocked(u, t, D, bz=4,
                                                       double_buffer=True),
                    lambda: column.jvp(u, t, D, 4),
                    lambda: stencil3d.rd3d_jvp_blocked_plain(u, t, D)),
                "rd3d_jvp_scaled": (
                    "bz=8 (the 3D chain's)",
                    lambda: stencil3d.rd3d_jvp_scaled(u, t, D, inv, bz=8),
                    lambda: column.scaled(u, t, D, inv, 8),
                    lambda: stencil3d.rd3d_jvp_scaled_plain(u, t, D, inv)),
            }
            for name, (config, kern, first, plain) in cases.items():
                ms_new, ms_first = side_by_side_ms(torch, kern, first)
                ms = sum(ms_new) / 2
                plain_ms = graph_time_ms(torch, plain, calls=5, replays=10)
                bms, by = rd3d_bound_ms(name, u.numel(), dname,
                                        u.element_size())
                abs_err = max(e[0] for k, e in errs.items()
                              if k.startswith(name + " "))
                timing = {"phase": "kernel_time_3d", "case": name,
                          "config": config, "shape": list(shape),
                          "dtype": dname, "max_abs_err": abs_err, "ms": ms,
                          "ms_readings": ms_new,
                          "first_design_ms_readings": ms_first,
                          "first_design_share_of_bound":
                              bms / (sum(ms_first) / 2),
                          "plain_ms": plain_ms, "bound_ms": bms,
                          "bound_by": by, "share_of_bound": bms / ms,
                          "gb_per_s": 3 * u.numel() * u.element_size()
                          / ms / 1e6}
                emit(timing)
                if dtype == torch.float32:
                    summary[name] = timing
            del u, t, ref, ref_s, tn
    return summary


def band_kernel_checks(torch, dev, spmv, spmv_stream, pattern, bplan,
                       jac_data):
    """K7 on the band route's own tables (its (w, n_pad) columns, and the
    Jacobian at the root packed by the route's selection), f32 and f64,
    against its plain version, with inf written into every pad slot (y must
    be bit-equal); then K5 on the same matrix as CSR.  Each timed beside
    cuSPARSE.  Returns the f32 records by kernel."""
    import numpy as np
    n = pattern.shape[0]
    nnz = pattern.nnz
    indptr, indices = pattern.device_tables(dev)
    cols = bplan.cols_table(dev)
    pads = cols < 0
    x64 = torch.as_tensor(np.random.default_rng(5).standard_normal(n),
                          device=dev)
    records = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        item = torch.finfo(dtype).bits // 8
        data = jac_data.to(dtype).contiguous()
        x = x64.to(dtype)
        packed = bplan.pack_data(data)
        packed_inf = packed.clone()
        packed_inf[pads] = float("inf")
        csr_lib = torch.sparse_csr_tensor(indptr, indices, data, (n, n))

        def inf_pads(got):
            # inf in every pad slot: K7 must not read them
            y_inf = spmv_stream.band_spmv_packed(cols, packed_inf, x, n)
            torch.cuda.synchronize()
            return {"inf_pads_equal": bool(torch.equal(y_inf, got))}

        k7 = spmv_case(
            torch, "band_spmv", "band_route_256", dname,
            lambda: spmv_stream.band_spmv_packed(cols, packed, x, n),
            lambda: spmv_stream.band_spmv_plain(cols, packed, x, n),
            lambda: csr_lib @ x,
            (cols.numel() * 4 + nnz * item + 2 * n * item, 2 * nnz),
            [bplan.w, bplan.n_pad, nnz], extra_check=inf_pads)
        del packed_inf
        k5 = k5_case(torch, spmv, "band_route_256", dname, indptr, indices,
                     data, x, (n, n))
        if dtype == torch.float32:
            records = {"band_spmv": k7, "gather_spmv_same_tables": k5}
        del data, x, packed, csr_lib
    return records


def scatter_kernel_checks(torch, dev, spmv, spmv_scatter, pattern, splan,
                          jac_data):
    """K8 on the scatter route's own tables (each part's G columns, zones
    and R positions, the Jacobian at the root staged by the route's
    selection), f32 and f64: the product, one launch a part, bit for bit
    against the sequential reference (``scatter_part_sequential``: the
    plain products, each R level summed slot by slot, the parts added in
    order); then K5 on the same matrix as CSR.  Each timed beside
    cuSPARSE of A and the index_select yardstick.  Returns the records by
    (kernel, dtype)."""
    import numpy as np
    n = pattern.shape[0]
    nnz = pattern.nnz
    indptr, indices = pattern.device_tables(dev)
    tables = splan.tables(dev)
    x64 = torch.as_tensor(np.random.default_rng(6).standard_normal(n),
                          device=dev)
    records = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        item = torch.finfo(dtype).bits // 8
        data = jac_data.to(dtype).contiguous()
        x = x64.to(dtype)
        staged = splan.stage(data)
        # each part: gcol, gdata, pos, rptr and zstart read once, its x
        # columns once; y written once
        nbytes = n * item + sum(
            t.gcol.shape[0] * (4 + item) + t.pos.shape[0] * 4
            + (t.rptr.shape[0] + t.zstart.shape[0]) * 4
            + (t.c1 - t.c0) * item for t in tables)
        flops = 2 * nnz + (len(tables) - 1) * n

        def sequential():
            y = None
            for t, gdata in zip(tables, staged):
                y = spmv_scatter.scatter_part_sequential(t, gdata, x, y)
            return y

        csr_lib = torch.sparse_csr_tensor(indptr, indices, data, (n, n))
        records[("scatter_spmv_part", dname)] = spmv_case(
            torch, "scatter_spmv_part", "scatter_route_96_permuted", dname,
            lambda: splan.apply_staged(staged, x), sequential,
            lambda: csr_lib @ x, (nbytes, flops),
            [n, n, nnz, len(tables)], exact=True,
            yardstick=lambda: torch.index_select(x, 0, indices))
        records[("gather_spmv", dname)] = k5_case(
            torch, spmv, "scatter_route_96_permuted", dname, indptr, indices,
            data, x, (n, n))
        del data, x, staged, csr_lib
    return records


def periodic7_pattern(CSR, N, perm=None):
    """The 3D periodic 7-point Jacobian pattern on N³ (C order) as the
    port's CSR, built with numpy (the JAX package traces it;
    tests/test_torch_sparse3d.py holds the two equal).  With ``perm`` the
    unknowns are renumbered: entry (i, j) moves to (pinv[i], pinv[j])."""
    import numpy as np
    n = N ** 3
    i = np.arange(n, dtype=np.int64)
    x, y, z = i // (N * N), (i // N) % N, i % N

    def idx(a, b, c):
        return ((a % N) * N + (b % N)) * N + (c % N)
    cols = np.stack([idx(x - 1, y, z), idx(x, y - 1, z), idx(x, y, z - 1), i,
                     idx(x, y, z + 1), idx(x, y + 1, z), idx(x + 1, y, z)], 1)
    del x, y, z
    cols.sort(axis=1)
    cols = cols.reshape(-1)
    indptr = np.arange(n + 1, dtype=np.int64) * 7
    if perm is not None:
        pinv = np.argsort(perm)
        rows = pinv[np.repeat(i, 7)]
        cols = pinv[cols]
        order = np.argsort(rows * n + cols, kind="stable")
        cols = cols[order]
        indptr = np.concatenate([[0], np.cumsum(np.bincount(rows,
                                                            minlength=n))])
    return CSR(None, cols.astype(np.int32), indptr.astype(np.int32), (n, n))


def flat3d_problem(nls, reaction_diffusion, N, dtype, dev, pattern,
                   perm=None, colorvec=None):
    """The flat 3D reaction–diffusion problem (u0 = 0.1, the residual on
    flat vectors) with its sparsity pattern; with ``perm``, its unknowns
    permuted: w = u[perm], G(w) = F(w[pinv])[perm]."""
    import numpy as np
    import torch
    u0 = torch.full((N ** 3,), 0.1, dtype=dtype, device=dev)
    p = (torch.tensor(0.01, dtype=dtype, device=dev),
         reaction_diffusion.forcing(N, dtype, device=dev))
    if perm is None:
        def residual(u, p_):
            return reaction_diffusion.reaction_diffusion_3d(
                u.reshape(N, N, N), p_).reshape(-1)
        return nls.NonlinearProblem(
            nls.NonlinearFunction(f=residual, sparsity=pattern,
                                  colorvec=colorvec), u0, p)
    perm_t = torch.as_tensor(perm, device=dev)
    pinv_t = torch.as_tensor(np.argsort(perm), device=dev)

    def permuted(w, p_):
        return reaction_diffusion.reaction_diffusion_3d(
            w[pinv_t].reshape(N, N, N), p_).reshape(-1)[perm_t]
    return nls.NonlinearProblem(
        nls.NonlinearFunction(f=permuted, sparsity=pattern,
                              colorvec=colorvec), u0[perm_t], p)


def sparse_alg3d(nls, fft_poisson_preconditioner, N, perm=None, dev=None):
    """slice 3's operating point with the colored sparse-AD Jacobian:
    GMRES(8), krylov_maxiter 200, the FFT Poisson preconditioner on
    (N, N, N) with shift −0.9 (conjugated by ``perm``), η = 0.1."""
    import numpy as np
    import torch
    M = fft_poisson_preconditioner((N, N, N), 0.01, 1.0 / N, shift=-0.9)
    if perm is not None:
        perm_t = torch.as_tensor(perm, device=dev)
        pinv_t = torch.as_tensor(np.argsort(perm), device=dev)
        M = (lambda v, M0=M: M0(v[pinv_t])[perm_t])
    return nls.NewtonRaphson(
        autodiff=nls.JacobianPolicy(mode="sparse"),
        linsolve=nls.LinearSolver(method="gmres", restart=8,
                                  krylov_maxiter=200, precond_fn=M),
        forcing=nls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))


def flat_problem(nls, brusselator, N, dtype, dev, perm=None,
                 with_pattern=True):
    """The flat Brusselator (u0.reshape(-1), the residual on flat vectors)
    with its sparsity pattern; with ``perm``, its unknowns permuted:
    w = u[perm], G(w) = F(w[pinv])[perm], pattern (pinv[rows], pinv[cols]).
    ``with_pattern=False`` gives no pattern (the solve detects it)."""
    import numpy as np
    import torch
    pat = brusselator.sparsity_pattern(N)
    u0 = brusselator.init_u0(N, dtype, device=dev).reshape(-1)
    p = brusselator.default_p(N, dtype, device=dev)
    if perm is None:
        def residual(u, p_):
            return brusselator.brusselator_2d(u.reshape(N, N, 2),
                                              p_).reshape(-1)
        return nls.NonlinearProblem(nls.NonlinearFunction(
            f=residual, sparsity=pat if with_pattern else None), u0, p)
    pinv = np.argsort(perm)
    perm_t = torch.as_tensor(perm, device=dev)
    pinv_t = torch.as_tensor(pinv, device=dev)

    def permuted(w, p_):
        return brusselator.brusselator_2d(w[pinv_t].reshape(N, N, 2),
                                          p_).reshape(-1)[perm_t]
    coo = (pinv[pat.row_ids], pinv[pat.indices])
    return nls.NonlinearProblem(nls.NonlinearFunction(
        f=permuted, sparsity=coo if with_pattern else None), u0[perm_t], p)


def sparse_alg(nls, fft_poisson_preconditioner, N, perm=None, dev=None):
    """NewtonRaphson with the colored sparse-AD Jacobian, GMRES(8) + the FFT
    Poisson preconditioner (conjugated by ``perm``), η = 0.1."""
    import numpy as np
    import torch
    M = fft_poisson_preconditioner((N, N), alpha=10.0, h=1.0 / (N - 1),
                                   shift=3.0, n_components=2)
    if perm is not None:
        perm_t = torch.as_tensor(perm, device=dev)
        pinv_t = torch.as_tensor(np.argsort(perm), device=dev)
        M = (lambda v, M0=M: M0(v[pinv_t])[perm_t])
    return nls.NewtonRaphson(
        autodiff=nls.JacobianPolicy(mode="sparse"),
        linsolve=nls.LinearSolver(method="gmres", restart=8,
                                  krylov_maxiter=100, precond_fn=M),
        forcing=nls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))


# the dense path's device time by class: cuSOLVER / cuBLAS kernels by name
DENSE_GROUPS = {"dense linear algebra": (
    "getrf", "getrs", "laswp", "trsm", "trsv", "potrf", "potrs", "svd",
    "gesvd", "geqrf", "ormqr", "orgqr", "larf", "iamax", "gemm", "gemv",
    "xmma", "cutlass", "syrk", "ger_", "swap", "scal", "cusolver",
    "cublas")}


def dense_run_report(torch, nls, _backend, name, prob, alg, jac_fn,
                     card, profile=True, **kw):
    """One dense solve: counters at 0 just before and read just after, the
    first solve timed; with ``profile`` then the warm wall (median of 3),
    the device time by class (the Jacobian timed alone × njacs; the dense
    linear algebra by kernel name; the rest) and the idle share of a
    profiled warm solve. With ``profile=False`` only the first solve runs
    (the profiler's event processing of a solve of many seconds takes
    minutes)."""
    t_report = time.perf_counter()
    torch.cuda.synchronize()
    _backend.reset_counters()
    t0 = time.perf_counter()
    sol = nls.solve(prob, alg, **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: v for k, v in _backend.LAUNCHES.items() if v}
    if sol.retcode != nls.ReturnCode.Success:
        raise AssertionError(f"dense {name}: {sol.retcode.name}")
    rec = {"phase": "dense_brusselator", "run": name,
           "n": int(prob.u0.numel()), "retcode": sol.retcode.name,
           "resid_inf": float(sol.resid.abs().max()),
           "stats": vars(sol.stats),
           "host_syncs": sol.counters["host_syncs"],
           "custom_kernel_launches": launches, "first_solve_s": first_s}
    if profile:
        walls = warm_walls(torch, lambda: nls.solve(prob, alg, **kw))
        prof = profile_device(torch, lambda: nls.solve(prob, alg, **kw),
                              groups=DENSE_GROUPS, host_events=False)
        # the Jacobian's kernels alone, one evaluation, × the Jacobians
        jac = profile_device(torch, lambda: jac_fn(sol.u), groups={},
                             host_events=False)
        jac_ms = (jac["device_busy_ms"] * sol.stats.njacs
                  if isinstance(jac["device_busy_ms"], float)
                  else "not measured")
        by_class = dict(prof["device_ms_by_group"])
        if isinstance(jac_ms, float):
            by_class["jacobian (batched residual, timed alone x njacs)"] = \
                jac_ms
            by_class["the rest"] = by_class.pop("other", 0.0) - jac_ms
        rec.update({"warm_wall_s": walls,
                    "warm_wall_s_median": sorted(walls)[len(walls) // 2],
                    "device_ms_by_class": by_class,
                    "device_busy_ms": prof["device_busy_ms"],
                    "device_idle_share": prof["device_idle_share"],
                    "profiled_solve_s": prof["profiled_solve_s"],
                    "profiled_solve": "warm",
                    "top_device_ms": prof["top_device_ms"]})
    else:
        unmeasured = "not measured (one solve, not profiled, for time)"
        rec.update({"warm_wall_s_median": unmeasured,
                    "device_ms_by_class": unmeasured,
                    "device_idle_share": unmeasured})
    rec.update({"report_s": time.perf_counter() - t_report, "card": card})
    emit(rec)
    if launches:
        raise AssertionError(f"dense {name} launched custom kernels: "
                             f"{launches}")
    return sol


def dense_brusselator_phase(torch, nls, _backend, brusselator,
                            fft_poisson_preconditioner, card):
    """Phase 18 (see the module docstring)."""
    from nonlinearsolve_tpu_torch.core.descent import DescentCtx
    from nonlinearsolve_tpu_torch.core.jacobian import construct_jacobian
    dev, f64 = torch.device("cuda"), torch.float64
    t_phase = time.perf_counter()

    def jac_of(prob):
        ctx = DescentCtx(f_flat=lambda u: brusselator.brusselator_2d(
            u, prob.p), n_in=prob.u0.numel(), n_out=prob.u0.numel())
        return construct_jacobian(nls.JacobianPolicy(), None, ctx, None)[0]

    N = 32
    pm = fft_poisson_preconditioner((N, N), alpha=10.0, h=1.0 / (N - 1),
                                    shift=3.0, n_components=2)
    gmres = nls.LinearSolver(method="gmres", restart=30, precond_fn=pm)
    t_refs = time.perf_counter()
    mf = nls.solve(brusselator.make_problem(N, f64, kernel_jvp=True),
                   nls.NewtonRaphson(linsolve=gmres), abstol=1e-10)
    sp = nls.solve(flat_problem(nls, brusselator, N, f64, dev),
                   nls.NewtonRaphson(autodiff=nls.JacobianPolicy(
                       mode="sparse"), linsolve=gmres), abstol=1e-10)
    if not (mf.success and sp.success):
        raise AssertionError(f"dense rung references: matrix-free "
                             f"{mf.retcode.name}, sparse {sp.retcode.name}")
    refs = {"matrix_free": mf.u, "sparse_ad": sp.u.reshape(N, N, 2)}
    refs_s = time.perf_counter() - t_refs
    prob = brusselator.make_problem(N, f64)
    jac_fn = jac_of(prob)
    # LevenbergMarquardt at 1e-8: at 1e-10 it stalls at the floor of its
    # least-squares step, in the JAX package too (N=8, 16 on the CPU)
    algs = {"NewtonRaphson": (nls.NewtonRaphson(), 1e-10),
            "TrustRegion": (nls.TrustRegion(), 1e-10),
            "LevenbergMarquardt": (nls.LevenbergMarquardt(), 1e-8),
            "PseudoTransient": (nls.PseudoTransient(alpha_initial=10.0),
                                1e-10)}
    dists, roots = {}, {}
    for name, (alg, abstol) in algs.items():
        # LM's step is a 4096×2048 SVD (about 0.5 s): a cap on its steps
        # bounds the phase if it ever left its 28-step course; its one
        # solve (15.8 s) is timed, not profiled
        lm = name == "LevenbergMarquardt"
        sol = dense_run_report(torch, nls, _backend, name, prob, alg,
                               jac_fn, card, abstol=abstol,
                               maxiters=60 if lm else 1000,
                               profile=not lm)
        dists[name] = {k: float((sol.u - r).abs().max())
                       for k, r in refs.items()}
        roots[name] = sol.u
    emit({"phase": "dense_brusselator_ladder", "N": N,
          "root_inf_distance": dists, "limit": 1e-8,
          "reference_stats": {"matrix_free": vars(mf.stats),
                              "sparse_ad": vars(sp.stats)},
          "references_s": refs_s})
    far = {k: v for k, v in dists.items()
           if not max(v.values()) <= 1e-8}
    if far:
        raise AssertionError(f"dense roots off the ladder: {far}")
    # N=64 at 1e-9: the f64 floor of |F| grows with α/dx² (4.7e-11 at the
    # N=32 root; at 1e-10, N=64 stalls on it)
    prob64 = brusselator.make_problem(64, f64)
    dense_run_report(torch, nls, _backend, "NewtonRaphson N=64", prob64,
                     nls.NewtonRaphson(), jac_of(prob64), card,
                     abstol=1e-9)
    emit({"phase": "dense_brusselator_done",
          "phase_seconds": time.perf_counter() - t_phase, "card": card})
    return roots["NewtonRaphson"]


# tests/test_23_problems.py CASES rows of the dense surface
ROWS_23 = {"NewtonRaphson": {1}, "TrustRegion": {11, 21},
           "LevenbergMarquardt": {11, 21}}
# NewtonRaphson's problem 1 runs all 10000 steps (about 30 s on the card):
# tests/test_torch_cuda.py holds it to the row, not this phase
ROWS_23_ON_CARD_TESTS = {"NewtonRaphson": {1}}
# tests/test_nlls_problems.py: the pairs it skips as hard starts
NLLS_BROKEN = {("powell_badly_scaled", "gauss_newton"),
               ("freudenstein_roth", "gauss_newton"),
               ("box_3d", "gauss_newton"), ("box_3d", "trustregion"),
               ("freudenstein_roth", "trustregion"),
               ("freudenstein_roth", "lm")}


def problems23_phase(torch, nls, _backend, card):
    """Phase 19 (see the module docstring)."""
    from nonlinearsolve_tpu_torch.models.nlls_problems import NLLS_PROBLEMS
    from nonlinearsolve_tpu_torch.models.problems23 import PROBLEMS_23
    dev, f64 = torch.device("cuda"), torch.float64
    t_phase = time.perf_counter()
    make = {"NewtonRaphson": nls.NewtonRaphson, "TrustRegion":
            nls.TrustRegion, "LevenbergMarquardt": nls.LevenbergMarquardt}
    torch.cuda.synchronize()
    _backend.reset_counters()
    syncs0 = _backend.HOST_SYNCS["n"]
    failed = []
    for row, expected in ROWS_23.items():
        t0 = time.perf_counter()
        broken, steps = set(), {}
        skip = ROWS_23_ON_CARD_TESTS.get(row, set())
        expected = expected - skip
        for tp in PROBLEMS_23:
            if tp.index in skip:
                continue
            sol = nls.solve(nls.NonlinearProblem(
                tp.f, torch.tensor(tp.start, dtype=f64, device=dev)),
                make[row](), maxiters=10000)
            if not float(tp.f(sol.u).abs().max()) <= 1e-4:
                broken.add(tp.index)
            steps[tp.index] = sol.stats.nsteps
        emit({"phase": "problems23", "row": row, "broken": sorted(broken),
              "expected": sorted(expected),
              "in_tests_test_torch_cuda": sorted(skip), "nsteps": steps,
              "seconds": time.perf_counter() - t0, "card": card})
        if broken != expected:
            failed.append(row)
    t0 = time.perf_counter()
    nlls = {"gauss_newton": nls.GaussNewton, "lm": nls.LevenbergMarquardt,
            "trustregion": nls.TrustRegion}
    ssq_rows = []
    for name, f, u0, _, expected_ssq in NLLS_PROBLEMS:
        for alg, mk in nlls.items():
            sol = nls.solve(nls.NonlinearLeastSquaresProblem(
                f, torch.tensor(u0, dtype=f64, device=dev)), mk(),
                maxiters=1000)
            ssq = float((sol.resid ** 2).sum())
            ok = ssq < max(1e-9, expected_ssq * 1.01 + 1e-9)
            ssq_rows.append({"problem": name, "alg": alg, "ssq": ssq,
                             "retcode": sol.retcode.name, "ok": ok,
                             "skipped_in_jax_test":
                                 (name, alg) in NLLS_BROKEN})
            if not ok and (name, alg) not in NLLS_BROKEN:
                failed.append(f"nlls {name}/{alg}")
    launches = {k: v for k, v in _backend.LAUNCHES.items() if v}
    emit({"phase": "nlls", "results": ssq_rows,
          "seconds": time.perf_counter() - t0,
          "host_syncs": _backend.HOST_SYNCS["n"] - syncs0,
          "custom_kernel_launches": launches,
          "phase_seconds": time.perf_counter() - t_phase, "card": card})
    if launches:
        failed.append(f"custom kernels launched: {launches}")
    if failed:
        raise AssertionError(f"23-problem / NLLS phase failed: {failed}")


# Phase 20: the JAX package's outcomes on the CPU, f64, that the card is
# held to (dense Brusselator N=32, abstol 1e-10: the default ladder runs
# Broyden for 22 steps, Klement for 1000 and NewtonRaphson for 4)
JAX_DENSE32_DEFAULT = {"nsteps": 1026, "nf": 1032, "njacs": 4}
# engine: (retcode, nsteps, nf, the other outcome the JAX package gives
# with one start component one ulp up — flat index, retcode, nsteps).
# Broyden and LimitedMemoryBroyden diverge here, and whether the run
# overflows (Unstable) or stalls or spends its resets first is a
# knife-edge of the JAX package's own (tests/test_torch_polyalg.py
# holds these outcomes); either outcome passes.
JAX_DENSE32_ENGINES = {
    "Broyden": ("Unstable", 22, 24, (1304, "Stalled", 53)),
    "Klement": ("MaxIters", 1000, 1002, None),
    "LimitedMemoryBroyden": ("ConvergenceFailure", 37, 39,
                             (1046, "Unstable", 31)),
    "DFSane": ("MaxIters", 1000, 4778, None)}
# the device time of the quasi-Newton runs by class
QN_GROUPS = {
    "cuBLAS (J·v, rank-1 updates)": ("gemv", "gemm", "ger", "dot_kernel",
                                     "xmma", "cutlass", "cublas"),
    "cuSOLVER (Newton's LU)": ("getrf", "getrs", "laswp", "trsm", "trsv",
                               "iamax", "cusolver", "potrf"),
    "reductions (norms, flags)": ("reduce",),
    "elementwise (residual, steps)": ("elementwise", "vectorized",
                                      "unrolled", "copy", "fill")}


def _qn_rows(nls):
    """tests/test_23_problems.py CASES rows of the quasi-Newton, spectral
    and polyalgorithm engines: (algorithm — None for the default —, the
    broken set, the problems that take 1000 steps or more in the JAX
    package, which tests/test_torch_cuda.py runs)."""
    def broyden_tr():
        return nls.QuasiNewtonAlgorithm(
            update_rule="good_broyden", structure="full",
            trustregion=nls.GenericTrustRegionScheme(), name="BroydenTR")
    return {
        "Broyden": (nls.Broyden, {1, 5, 6, 11, 18}, {1, 6, 21}),
        "Broyden-TrueJacobian": (
            lambda: nls.Broyden(init_jacobian="true_jacobian"),
            {1, 5, 6, 8, 11, 21}, {5, 21}),
        "Broyden-BadBroyden": (
            lambda: nls.Broyden(update_rule="bad_broyden"),
            {1, 5, 9, 11, 18}, {11}),
        "Broyden-TrueJacobian-Bad": (
            lambda: nls.Broyden(init_jacobian="true_jacobian",
                                update_rule="bad_broyden"),
            {1, 5, 6, 8, 11}, {5, 11}),
        "Klement": (nls.Klement, {1, 2, 4, 5, 6, 7, 11, 22},
                    {4, 5, 6, 7, 8, 9, 11, 22}),
        "Klement-TrueJacDiagonal": (
            lambda: nls.Klement(init_jacobian="true_jacobian_diagonal"),
            {2, 4, 5, 6, 11, 22}, {4, 6, 7, 8, 9, 11, 12, 22}),
        "DFSane": (nls.DFSane, {1, 2, 3, 5, 21}, {1, 2, 3, 5, 6, 21}),
        "LimitedMemoryBroyden": (nls.LimitedMemoryBroyden,
                                 {1, 5, 6, 11, 18}, {6, 21}),
        "RobustMultiNewton": (nls.RobustMultiNewton, set(), set()),
        "DefaultPolyalgorithm": (None, set(), {1, 4, 5, 6, 11, 21}),
        "Broyden-TrustRegion": (broyden_tr, {3, 5, 11, 21}, {1, 21}),
        "LimitedMemoryBroyden-thresh2": (
            lambda: nls.LimitedMemoryBroyden(threshold=2),
            {1, 2, 4, 5, 6, 8, 9, 10, 11, 13, 14, 18, 19, 23}, {21}),
    }


def large_n_problems(p23, n):
    """tests/test_23_problems.py's ``_large_n_problems``: the 11 problems
    that generalize in dimension, with their starts at size ``n``."""
    import numpy as np
    t = np.arange(1, n + 1) / (n + 1)
    return [
        (1, p23._rosenbrock, [-1.2] + [1.0] * (n - 1)),
        (8, p23._brown_almost_linear, [0.5] * n),
        (9, p23._discrete_bvp, list(t * (t - 1.0))),
        (10, p23._discrete_integral, list(t * (t - 1.0))),
        (11, p23._trigonometric, [1.0 / n] * n),
        (12, p23._variably_dimensioned,
         list(1.0 - np.arange(1, n + 1) / n)),
        (13, p23._broyden_tridiagonal, [-1.0] * n),
        (14, p23._broyden_banded, [-1.0] * n),
        (18, p23._exponential_fn, [1.0 / (4.0 * n * n)] * n),
        (19, p23._logarithmic_fn, [1.0] * n),
        (23, p23._chandrasekhar, [1.0] * n),
    ]


def qn_polyalg_phase(torch, nls, _backend, brusselator, nr_root, card):
    """Phase 20 (see the module docstring).  ``nr_root``: phase 18's
    NewtonRaphson root at N=32."""
    import numpy as np
    from nonlinearsolve_tpu_torch.models import problems23 as p23
    dev, f64 = torch.device("cuda"), torch.float64
    t_phase = time.perf_counter()
    failed = []

    def counted(run):
        torch.cuda.synchronize()
        _backend.reset_counters()
        t0 = time.perf_counter()
        sol = run()
        torch.cuda.synchronize()
        return sol, time.perf_counter() - t0, \
            {k: v for k, v in _backend.LAUNCHES.items() if v}

    # (a) the quickstart
    prob = nls.NonlinearProblem(lambda u, p: u * u - p,
                                torch.tensor([1.0, 1.0], dtype=f64,
                                             device=dev), 2.0)
    sol, secs, launches = counted(lambda: nls.solve(prob))
    dist = float((sol.u - math.sqrt(2.0)).abs().max())
    ok = sol.retcode == nls.ReturnCode.Success and dist <= 1e-8
    emit({"phase": "qn_quickstart", "retcode": sol.retcode.name,
          "root_inf_distance_to_sqrt2": dist, "stats": vars(sol.stats),
          "rungs": sol.counters["rungs"], "winner": sol.counters["winner"],
          "host_syncs": sol.counters["host_syncs"], "seconds": secs,
          "custom_kernel_launches": launches, "ok": ok, "card": card})
    if not ok or launches:
        failed.append("quickstart")

    # (b) the default polyalgorithm on the dense Brusselator, N=32
    N = 32
    bprob = brusselator.make_problem(N, f64)
    run = lambda: nls.solve(bprob, abstol=1e-10)     # noqa: E731
    sol, first_s, launches = counted(run)
    dist = float((sol.u - nr_root).abs().max())
    # the warm wall is the profiled solve's (one run for both, for time)
    prof = profile_device(torch, run, groups=QN_GROUPS, host_events=False)
    walls = [prof["profiled_solve_s"]]
    ok = sol.retcode == nls.ReturnCode.Success and dist <= 1e-8
    emit({"phase": "qn_default_dense_brusselator", "N": N,
          "n": int(bprob.u0.numel()), "retcode": sol.retcode.name,
          "resid_inf": float(sol.resid.abs().max()),
          "root_inf_distance_to_phase18_nr": dist, "limit": 1e-8,
          "stats": vars(sol.stats), "jax_stats": JAX_DENSE32_DEFAULT,
          "rungs": sol.counters["rungs"], "winner": sol.counters["winner"],
          "host_syncs": sol.counters["host_syncs"],
          "host_syncs_per_step": sol.counters["host_syncs"]
          / max(sol.stats.nsteps, 1),
          "custom_kernel_launches": launches, "first_solve_s": first_s,
          "warm_wall_s_one": walls[0],
          "device_ms_by_class": prof["device_ms_by_group"],
          "device_busy_ms": prof["device_busy_ms"],
          "device_idle_share": prof["device_idle_share"],
          "profiled_solve_s": prof["profiled_solve_s"],
          "top_device_ms": prof["top_device_ms"], "ok": ok, "card": card})
    if not ok or launches:
        failed.append("default polyalgorithm, dense Brusselator")

    # (c) the four engines alone at N=32
    for name, (want, jsteps, jnf, edge) in JAX_DENSE32_ENGINES.items():
        alg = getattr(nls, name)()
        run = lambda: nls.solve(bprob, alg, abstol=1e-10)  # noqa: E731
        sol, first_s, launches = counted(run)
        on_edge = edge is not None and sol.retcode.name == edge[1]
        ok = (sol.retcode.name == want or on_edge) and not launches
        emit({"phase": "qn_engine_dense_brusselator", "engine": name,
              "N": N, "retcode": sol.retcode.name, "jax_retcode": want,
              "jax_one_ulp_moved_start": edge, "knife_edge_side": on_edge,
              "stats": vars(sol.stats),
              "jax_nsteps_nf": [jsteps, jnf],
              "resid_inf": float(sol.resid.abs().max()),
              "host_syncs": sol.counters["host_syncs"],
              "host_syncs_per_step": sol.counters["host_syncs"]
              / max(sol.stats.nsteps, 1),
              "first_solve_s": first_s,
              "warm_wall_s_one": "not measured (one solve, for time)",
              "ms_per_step": "not measured (no warm solve, for time)",
              "first_solve_ms_per_step":
                  1e3 * first_s / max(sol.stats.nsteps, 1),
              "ok": ok, "card": card})
        if not ok:
            failed.append(f"{name} alone at N=32")

    # (d) the CASES rows on the 23 problems, the short cases
    for row, (make, broken, long) in _qn_rows(nls).items():
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        _backend.reset_counters()
        got, steps = set(), {}
        for tp in p23.PROBLEMS_23:
            if tp.index in long:
                continue
            tprob = nls.NonlinearProblem(
                tp.f, torch.tensor(tp.start, dtype=f64, device=dev))
            sol = (nls.solve(tprob, maxiters=10000) if make is None
                   else nls.solve(tprob, make(), maxiters=10000))
            if not float(tp.f(sol.u).abs().max()) <= 1e-4:
                got.add(tp.index)
            steps[tp.index] = sol.stats.nsteps
        launches = {k: v for k, v in _backend.LAUNCHES.items() if v}
        expected = broken - long
        emit({"phase": "qn_problems23", "row": row, "broken": sorted(got),
              "expected": sorted(expected),
              "in_tests_test_torch_cuda": sorted(long), "nsteps": steps,
              "steps": sum(steps.values()),
              "seconds": time.perf_counter() - t0,
              "custom_kernel_launches": launches, "card": card})
        if got != expected or launches:
            failed.append(row)
    large = {"LimitedMemoryBroyden-n64": (
        lambda: nls.LimitedMemoryBroyden(threshold=27),
        {1, 9, 11, 13, 14, 18}),
        "Broyden-n64-control": (nls.Broyden, {1, 9, 11, 18})}
    for row, (make, broken) in large.items():
        t0 = time.perf_counter()
        got, steps = set(), {}
        for idx, f, x0 in large_n_problems(p23, 64):
            sol = nls.solve(nls.NonlinearProblem(
                f, torch.tensor(np.asarray(x0), dtype=f64, device=dev)),
                make(), maxiters=10000)
            if not float(f(sol.u).abs().max()) <= 1e-4:
                got.add(idx)
            steps[idx] = sol.stats.nsteps
        emit({"phase": "qn_problems23_n64", "row": row,
              "broken": sorted(got), "expected": sorted(broken),
              "nsteps": steps, "seconds": time.perf_counter() - t0,
              "card": card})
        if got != broken:
            failed.append(row)
    emit({"phase": "qn_polyalg_done",
          "phase_seconds": time.perf_counter() - t_phase, "card": card})
    if failed:
        raise AssertionError(f"quasi-Newton / polyalgorithm phase failed: "
                             f"{failed}")


# Phase 21: the JAX package's outcomes on the CPU, f64, NewtonRaphson with a
# colored sparse-AD Jacobian (retcode, nsteps, nf, njacs; None: not
# recorded) and the route each run takes (_backend.ROUTES: the direct
# routes and the device LU's solves)
JAX_SPARSE_DIRECT = {
    "a_bratu32_default": ("Success", 4, 6, 4, "bcr"),
    "b_snes_ex2_128_sparse": ("Success", 3, 5, 3, "pcr"),
    "c_bratu128_default": ("Success", 4, 6, 4, "host_lu"),
    "d_bratu128_sparse_lu_device": ("Success", 4, 6, 4, "device_lu"),
    "e_bratu128_flat_gmres_device_lu": ("Success", 4, 6, 4, "gmres"),
    "f_bratu256_default": ("Success", 3, 5, None, "iterative"),
}
# the 128² Bratu plan of the JAX package (AMD order, f64): L + U stages, ELL
DEVICE_LU_128 = {"L_stages": 12, "U_stages": 43, "ell_stages": 28,
                 "nnzL": 702130}
# the device time of the sparse direct runs by class
SPARSE_DIRECT_GROUPS = {
    "K4 dia_spmv": ("dia_spmv",), "K5 gather_spmv": ("csr_spmv",),
    "K5 selection": ("csr_select",),
    "batched solves (cuSOLVER / cuBLAS)": ("getrf", "getrs", "trsm",
                                           "batch", "lu_"),
    "gemm/gemv": ("gemm", "gemv", "dot_kernel"),
    "reductions": ("reduce_kernel",), "copies": ("copy", "memcpy"),
    "elementwise": ("elementwise",)}


def bratu_flat(torch, nls, bratu, N, dev):
    """Bratu on the flat state (N·N,), the shape GMRES's sparse route
    needs, as the JAX package's row (e) runs it."""
    def f(u, p):
        return bratu.bratu_2d(u.reshape(N, N), p).reshape(-1)

    return nls.NonlinearProblem(
        nls.NonlinearFunction(f=f, sparsity=bratu.sparsity_pattern(N)),
        torch.zeros(N * N, dtype=torch.float64, device=dev),
        torch.tensor(3.5, dtype=torch.float64, device=dev))


def bratu_lu_data(torch, bratu, N, dev):
    """Jacobian-like data on the Bratu pattern at N² (diagonal −4,
    off-diagonals 1, each scaled by a seeded U(0.9, 1.1))."""
    import numpy as np
    pat = bratu.sparsity_pattern(N)
    rng = np.random.default_rng(N)
    scale = rng.uniform(0.9, 1.1, pat.nnz)
    return pat, torch.as_tensor(
        scale * np.where(pat.indices == pat.row_ids, -4.0, 1.0), device=dev)


def device_lu_stage_checks(torch, spmv, lu, data, dev):
    """K5 on every gather table of the 128² plan (the ELL stages and the
    dense stages' pre-gathers, with the refreshed values of ``data``)
    against its plain version, f64 and f32 (the same tables, values and x
    cast), each at TOL; then the gathers of one solve timed together: K5
    (a CUDA graph of them all), the plain versions, and cuSPARSE on the
    same stage CSRs, beside the byte bound of their tables.  One stage (the
    largest ELL table) gets the full kernel_check record."""
    import numpy as np
    _Ud, Lst, Ust, ok = lu.refresh(data)
    if not ok:
        raise AssertionError("the 128² plan's refresh failed")
    tab = lu.tables(dev)
    n = lu.n
    rng = np.random.default_rng(21)
    x64 = torch.as_tensor(rng.standard_normal(n), device=dev)
    stages = []
    for kind, st, vals, tabs in (("L", lu.Lstages, Lst, tab["L"]),
                                 ("U", lu.Ustages, Ust, tab["U"])):
        for stage, sv, (indptr, indices) in zip(st, vals, tabs):
            if indices.shape[0] == 0:
                continue
            v = sv if stage[0] == "ell" else sv[2]
            cols = (stage[4] if stage[0] == "ell"
                    else stage[1]["pre"])["indices"]
            stages.append({"sweep": kind, "tag": stage[0], "indptr": indptr,
                           "indices": indices, "data": v,
                           "rows": int(indptr.shape[0] - 1),
                           "nnz": int(indices.shape[0]),
                           "cols_read": int(np.unique(cols).size)})
    worst = {"float64": 0.0, "float32": 0.0}
    for s in stages:
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[-1]
            d, x = s["data"].to(dtype), x64.to(dtype)
            got = spmv.gather_spmv(s["indptr"], s["indices"], d, x)
            ref = spmv.gather_spmv_plain(s["indptr"], s["indices"], d, x)
            worst[dname] = max(worst[dname], rel_err(got, ref)[1])
    ell = [s for s in stages if s["tag"] == "ell"]
    ok = all(worst[d] <= TOL[d] for d in worst)
    libs = [torch.sparse_csr_tensor(s["indptr"], s["indices"], s["data"],
                                    (s["rows"], n)) for s in stages]

    def k5_all():
        for s in stages:
            spmv.gather_spmv(s["indptr"], s["indices"], s["data"], x64)

    def plain_all():
        for s in stages:
            spmv.gather_spmv_plain(s["indptr"], s["indices"], s["data"],
                                   x64)

    def lib_all():
        for s, A in zip(stages, libs):
            A @ x64

    item = 8
    nbytes = sum(s["nnz"] * (item + 4) + (s["rows"] + 1) * 4
                 + (s["rows"] + s["cols_read"]) * item for s in stages)
    flops = sum(2 * s["nnz"] for s in stages)
    ms = graph_time_ms(torch, k5_all, calls=10, replays=10)
    ms_profiled = profiled_ms(torch, k5_all, calls=5)
    plain_ms = graph_time_ms(torch, plain_all, calls=2, replays=5)
    library_ms = profiled_ms(torch, lib_all, calls=5)
    bms, by = roofline_ms(nbytes, flops, "float64")
    big = max(ell, key=lambda s: s["nnz"])
    big_rec = k5_case(torch, spmv, "device_lu_128_largest_ell_stage",
                      "float64", big["indptr"], big["indices"], big["data"],
                      x64, (big["rows"], n))
    rec = {"phase": "kernel_check_device_lu_stages", "N": 128,
           "gathers": len(stages), "ell_stages": len(ell),
           "max_rel_err": worst, "tolerance": TOL, "ok": ok,
           "nnz_per_solve": sum(s["nnz"] for s in stages),
           "stage_rows": [s["rows"] for s in stages],
           "stage_nnz": [s["nnz"] for s in stages],
           "ms_per_solve": ms, "ms_profiled_per_solve": ms_profiled,
           "plain_ms_per_solve": plain_ms,
           "library_ms_per_solve": library_ms,
           "library": "cuSPARSE CSR matvec on each stage's CSR "
                      "(torch.sparse_csr_tensor @ x)",
           "bound_ms_per_solve": bms, "bound_by": by, "bound_bytes": nbytes,
           "share_of_bound": bms / ms, "dtype": "float64"}
    emit(rec)
    if not ok:
        raise AssertionError(f"K5 disagrees on a device-LU stage: {rec}")
    return rec, big_rec


def sparse_direct_kernel_checks(torch, spmv, plans, dev):
    """K4 and K5's selection on phase 21's own tables, against their plain
    versions, f64 and f32: K4 on the "dia" tier of the CSR Jacobians of
    runs (e) and (f), each assembled at its run's root with that run's
    colored plan (16,384 and 65,536 unknowns), at TOL; the selection on the
    CSR assembly tables of runs (a), (c) and (f) (32², 128², 256²), bit
    for bit.  Returns the records by kernel, keyed by tables and dtype."""
    import numpy as np
    rng = np.random.default_rng(12)
    keep = ("shape", "max_abs_err", "rel_err", "tolerance", "ms",
            "plain_ms", "bound_ms", "bound_by", "share_of_bound",
            "library_ms", "library_ms_eager_events")
    out = {"dia_spmv": {}, "gather_select": {}}
    for key in ("e_bratu128_flat_gmres_device_lu", "f_bratu256_default"):
        plan, prob, sol = plans[key]
        J = plan(lambda u: prob.f(u.reshape(prob.u0.shape), prob.p)
                 .reshape(-1), sol.u.reshape(-1))
        tier, dplan, perm, _pinv, _dperm = J.tier
        if tier != "dia" or perm is not None:
            raise AssertionError(f"{key}: the Jacobian's tier is {tier}")
        n = J.shape[0]
        in_band = sum(n - abs(o) for o in dplan.offsets)
        indptr, indices = J.device_tables(dev)
        dd64 = dplan.pack(J.data)
        x64 = torch.as_tensor(rng.standard_normal(n), device=dev)
        tables = f"{key[:1]}_bratu{int(round(n ** 0.5))}_jacobian_at_root"
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[-1]
            item = torch.finfo(dtype).bits // 8
            dd, x = dd64.to(dtype), x64.to(dtype)
            csr_lib = torch.sparse_csr_tensor(indptr, indices,
                                              J.data.to(dtype), (n, n))
            rec = spmv_case(
                torch, "dia_spmv", tables, dname,
                lambda: spmv.dia_spmv(dd, dplan.offsets, x),
                lambda: spmv.dia_spmv_plain(dd, dplan.offsets, x),
                lambda: csr_lib @ x,
                (in_band * item + 2 * n * item, 2 * in_band),
                [dplan.ndiag, n])
            out["dia_spmv"][f"{tables}_{dname}"] = {k: rec[k] for k in keep}
    for key in ("a_bratu32_default", "c_bratu128_default",
                "f_bratu256_default"):
        plan, prob, _sol = plans[key]
        tables = f"{key[:1]}_bratu{prob.u0.shape[0]}_csr_assembly"
        for dtype in (torch.float64, torch.float32):
            rec = selection_case(torch, spmv, plan._select, tables, dtype,
                                 dev, rng)
            out["gather_select"][f"{tables}_{rec['dtype']}"] = {
                k: rec[k] for k in keep}
    return out


def sparse_direct_phase(torch, nls, _backend, spmv, card):
    """Phase 21 (see the module docstring).  Returns the launches of each
    run and the device-LU stage records for the kernels line."""
    import numpy as np
    from nonlinearsolve_tpu_torch.models import bratu, snes_ex2
    from nonlinearsolve_tpu_torch.core.solve import _SPARSE_PLANS
    from nonlinearsolve_tpu_torch.ops import device_lu, direct_sparse
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    t_phase = time.perf_counter()
    failed, records, plans = [], {}, {}

    def sparse_nr(**ls):
        return nls.NewtonRaphson(autodiff=nls.JacobianPolicy(mode="sparse"),
                                 linsolve=nls.LinearSolver(**ls))

    def run(key, make, alg, abstol, **extra):
        """The counted first solve (counters at 0 just before, read just
        after), then one profiled solve (its wall the warm wall)."""
        prob = make(dev)
        solve = lambda: nls.solve(prob, alg, abstol=abstol)  # noqa: E731
        torch.cuda.synchronize()
        _backend.reset_counters()
        t0 = time.perf_counter()
        sol = solve()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {k: v for k, v in _backend.LAUNCHES.items() if v}
        routes = {k: v for k, v in _backend.ROUTES.items() if v}
        (plan,) = _SPARSE_PLANS[prob.f].values()
        # the warm wall is the profiled solve's (one run, for time)
        prof = profile_device(torch, solve, groups=SPARSE_DIRECT_GROUPS,
                              host_events=False)
        walls = [prof["profiled_solve_s"]]
        want, jsteps, jnf, jjacs, route = JAX_SPARSE_DIRECT[key]
        stats = vars(sol.stats)
        rec = {"phase": "sparse_direct", "run": key,
               "n": int(prob.u0.numel()), "dtype": "float64",
               "abstol": abstol, "retcode": sol.retcode.name,
               "stats": stats, "jax": {"retcode": want, "nsteps": jsteps,
                                       "nf": jnf, "njacs": jjacs},
               "resid_inf": float(sol.resid.abs().max()),
               "route": route, "routes": routes,
               "host_syncs": sol.counters["host_syncs"],
               "krylov_iters": sol.counters["krylov_iters"],
               "jac_products": sol.counters["jvp"], "launches": launches,
               "first_solve_s": first_s, "warm_wall_s_one": walls[0],
               "device_ms_by_class": prof["device_ms_by_group"],
               "device_busy_ms": prof["device_busy_ms"],
               "device_idle_share": prof["device_idle_share"],
               "profiled_solve_s": prof["profiled_solve_s"],
               "top_device_ms": prof["top_device_ms"], **extra,
               "card": card}
        checks = {
            "retcode as the JAX package's": sol.retcode.name == want,
            "nsteps, nf (and njacs) as the JAX package's": (
                stats["nsteps"] == jsteps and stats["nf"] == jnf
                and (jjacs is None or stats["njacs"] == jjacs)),
            "K5's selection assembles every Jacobian":
                launches.get("gather_select", 0) >= stats["njacs"] > 0,
        }
        if route == "gmres":
            checks["no direct route"] = not any(
                v for k, v in routes.items() if k != "device_lu")
        else:
            checks[f"route {route} at every linear solve"] = (
                routes.get(route, 0) == stats["nsolve"])
        rec["checks"] = checks
        records[key] = (rec, sol)
        plans[key] = (plan, prob, sol)
        return sol, launches, checks

    def finish(key, checks):
        rec = records[key][0]
        rec["ok"] = all(checks.values())
        emit(rec)
        if not rec["ok"]:
            failed.append((key, [k for k, v in checks.items() if not v]))

    def dist(a, b):
        return float((a.reshape(-1).to(b.device) - b.reshape(-1))
                     .abs().max())

    # (a) BASELINE config 3: Bratu 32², the default linear solver (BCR)
    sol, launches, checks = run(
        "a_bratu32_default", lambda d: bratu.make_problem(32, device=d),
        sparse_nr(), 1e-10)
    dense = nls.solve(bratu.make_problem(32, device=dev,
                                         with_sparsity=False),
                      nls.NewtonRaphson(), abstol=1e-10)
    d_a = dist(sol.u, dense.u)
    records["a_bratu32_default"][0]["root_inf_distance_to_dense_nr"] = d_a
    checks["root within 1e-10 of the dense NewtonRaphson root"] = (
        dense.retcode == nls.ReturnCode.Success and d_a <= 1e-10)
    checks["no K4 or K5 launch"] = not (launches.get("dia_spmv")
                                        or launches.get("gather_spmv"))
    finish("a_bratu32_default", checks)

    # (b) SNES ex2, n = 128, sparse: PCR
    sol, launches, checks = run(
        "b_snes_ex2_128_sparse",
        lambda d: snes_ex2.make_problem(128, sparse=True, device=d),
        sparse_nr(), 1e-8)
    dense = nls.solve(snes_ex2.make_problem(128, device=dev),
                      nls.NewtonRaphson(), abstol=1e-8)
    d_b = dist(sol.u, dense.u)
    records["b_snes_ex2_128_sparse"][0].update(
        root_inf_distance_to_dense_nr=d_b,
        dense_u0=float(dense.u[0]), dense_u_last=float(dense.u[-1]))
    checks["root within 1e-8 of the dense root"] = d_b <= 1e-8
    checks["u[0] = 0 and u[-1] = 1 to 1e-10"] = (
        abs(float(dense.u[0])) < 1e-10
        and abs(float(dense.u[-1]) - 1.0) < 1e-10)
    finish("b_snes_ex2_128_sparse", checks)

    # (c) Bratu 128², the default linear solver: the AMD host LU
    direct_sparse._FACTORS._d.clear()
    sol_c, launches, checks = run(
        "c_bratu128_default", lambda d: bratu.make_problem(128, device=d),
        sparse_nr(), 1e-10)
    (fac,) = direct_sparse._FACTORS._d.values()
    n_factor, n_refactor = fac.n_factor, fac.n_refactor
    cpu_c = nls.solve(bratu.make_problem(128, device=cpu), sparse_nr(),
                      abstol=1e-10)
    d_c = dist(sol_c.u, cpu_c.u)
    records["c_bratu128_default"][0].update(
        n_factor=n_factor, n_refactor=n_refactor,
        root_inf_distance_to_cpu=d_c)
    checks["one factorization, numeric refactorizations after it"] = (
        n_factor == 1 and n_refactor >= 1)
    checks["root within 1e-10 of the CPU port's"] = (
        d_c <= 1e-10 and vars(cpu_c.stats) == vars(sol_c.stats))
    finish("c_bratu128_default", checks)

    # (d) Bratu 128², sparse_lu_device: K5 on every gather of the sweeps
    alg_d = sparse_nr(method="sparse_lu_device")
    sol, launches, checks = run(
        "d_bratu128_sparse_lu_device",
        lambda d: bratu.make_problem(128, device=d), alg_d, 1e-10)
    pat = bratu.sparsity_pattern(128)
    lu = device_lu.device_lu_for(pat.indptr, pat.indices, 128 * 128,
                                 dtype=torch.float64)
    summary = lu.stage_summary()
    per_solve = summary["k5_launches_per_solve"]
    d_d = dist(sol.u, sol_c.u)
    lu_solves = records["d_bratu128_sparse_lu_device"][0]["routes"][
        "device_lu"]
    records["d_bratu128_sparse_lu_device"][0].update(
        plan=summary, expected_plan=DEVICE_LU_128,
        k5_launches_per_linear_solve=launches.get("gather_spmv", 0)
        / max(lu_solves, 1),
        refresh_s=dict(lu.refresh_times), root_inf_distance_to_c=d_d)
    checks["the JAX package's plan (12 + 43 stages, 28 ELL)"] = all(
        summary[k] == v for k, v in DEVICE_LU_128.items())
    checks["K5 on every gather of every solve"] = (
        launches.get("gather_spmv", 0) == per_solve * lu_solves > 0)
    checks["root within 1e-10 of (c)'s"] = d_d <= 1e-10
    finish("d_bratu128_sparse_lu_device", checks)

    # the solve alone: one refresh, a chain of solves between CUDA events
    # (128² f64, and the 64² f32 plan of bench.py's device_lu_solve row)
    b128 = torch.as_tensor(np.random.default_rng(5).standard_normal(
        128 * 128), device=dev)
    _pat, data128 = bratu_lu_data(torch, bratu, 128, dev)
    state = lu.refresh(data128)
    x_gpu, _ = lu.solve(state, b128)
    x_cpu, _ = lu.solve(lu.refresh(data128.cpu()), b128.cpu())
    solve_rel = rel_err(x_gpu, x_cpu.to(dev))[1]
    solve_ms = event_time_ms(torch, lambda: lu.solve(state, b128), calls=20)
    pat64, d64 = bratu_lu_data(torch, bratu, 64, dev)
    lu64 = device_lu.device_lu_for(pat64.indptr, pat64.indices, 64 * 64,
                                   dtype=torch.float32)
    state64 = lu64.refresh(d64)
    b64 = b128[:64 * 64].float().contiguous()
    solve64_ms = event_time_ms(torch, lambda: lu64.solve(state64, b64),
                               calls=20)
    torch.cuda.synchronize()
    _backend.reset_counters()
    lu.solve(state, b128)
    one_solve = dict(_backend.LAUNCHES)
    launches_solve = kernels_per_call(torch, lambda: lu.solve(state, b128),
                                      calls=5)
    t0 = time.perf_counter()
    lu.refresh(data128)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    rec = {"phase": "device_lu_solve", "N": 128, "dtype": "float64",
           "rel_err_card_vs_cpu": solve_rel, "tolerance": 1e-12,
           "solve_ms_events": solve_ms, "solve_ms_64_f32": solve64_ms,
           "plan_64_f32": lu64.stage_summary(),
           "k5_launches_per_solve": one_solve["gather_spmv"],
           "kernels_per_solve": sum(v["per_call"]
                                    for v in launches_solve.values()),
           "device_us_per_solve": sum(v["us_per_call"]
                                      for v in launches_solve.values()),
           "refresh_s": refresh_s, "refresh_parts_s": dict(lu.refresh_times),
           "state_values": summary["state_values"], "card": card}
    rec["ok"] = solve_rel <= 1e-12 and one_solve["gather_spmv"] == per_solve
    emit(rec)
    if not rec["ok"]:
        failed.append(("device_lu_solve", rec))
    stage_rec, big_rec = device_lu_stage_checks(torch, spmv, lu, data128,
                                                dev)
    stage_rec["launches_per_solve"] = per_solve

    # (e) Bratu 128² flat, GMRES with the device LU as preconditioner
    sol, launches, checks = run(
        "e_bratu128_flat_gmres_device_lu",
        lambda d: bratu_flat(torch, nls, bratu, 128, d),
        sparse_nr(method="gmres", precond="device_lu"), 1e-10)
    rec = records["e_bratu128_flat_gmres_device_lu"][0]
    d_e = dist(sol.u, sol_c.u)
    rec.update(root_inf_distance_to_c=d_e,
               krylov_iters_per_step=sol.counters["krylov_iters"]
               / max(sol.stats.nsteps, 1))
    checks["K4 in every product with J"] = (
        launches.get("dia_spmv", 0) == sol.counters["jvp"] > 0)
    checks["K5 on the preconditioner's sweeps"] = (
        launches.get("gather_spmv", 0) == per_solve * rec["routes"][
            "device_lu"] > 0)
    checks["1-3 Krylov iterations a step"] = (
        1 <= rec["krylov_iters_per_step"] <= 3)
    checks["root within 1e-10 of (c)'s"] = d_e <= 1e-10
    finish("e_bratu128_flat_gmres_device_lu", checks)

    # (f) Bratu 256², the default linear solver: BiCGStab + Jacobi over K4
    sol, launches, checks = run(
        "f_bratu256_default", lambda d: bratu.make_problem(256, device=d),
        sparse_nr(), 1e-8)
    cpu_f = nls.solve(bratu.make_problem(256, device=cpu), sparse_nr(),
                      abstol=1e-8)
    d_f = dist(sol.u, cpu_f.u)
    records["f_bratu256_default"][0]["root_inf_distance_to_cpu"] = d_f
    checks["K4 in BiCGStab's products"] = launches.get("dia_spmv", 0) > 0
    checks["root within 1e-10 of the CPU port's"] = d_f <= 1e-10
    finish("f_bratu256_default", checks)

    # (h) K4 and K5's selection on this path's own tables (spmv_case raises
    # where a kernel disagrees with its plain version)
    path_checks = sparse_direct_kernel_checks(torch, spmv, plans, dev)

    emit({"phase": "sparse_direct_done",
          "phase_seconds": time.perf_counter() - t_phase, "card": card})
    if failed:
        raise AssertionError(f"sparse direct phase failed: {failed}")
    return ({key: rec["launches"] for key, (rec, _sol) in records.items()},
            stage_rec, big_rec, path_checks)


# Phase 22: the batched tier.  The simple rows of tests/test_23_problems.py
# CASES: (algorithm, the JAX package's broken set, the problems that take
# 1000 steps or more in the JAX package, left to
# tests/test_torch_23_simple_long.py on the CPU).
def _simple_rows(nls):
    return {
        "SimpleNewtonRaphson": (nls.SimpleNewtonRaphson, {1}, {1}),
        "SimpleBroyden": (nls.SimpleBroyden, {1, 6, 11, 18},
                          {1, 6, 11, 18, 21}),
        "SimpleKlement": (nls.SimpleKlement, {1, 2, 4, 5, 6, 7, 11, 13, 22},
                          {1, 2, 4, 5, 6, 7, 8, 9, 11, 12, 13, 22}),
        "SimpleDFSane": (nls.SimpleDFSane, {1, 2, 3, 5, 21},
                         {1, 2, 3, 4, 5, 6, 21}),
        "SimpleHalley": (nls.SimpleHalley, {1}, {1}),
        "SimpleTrustRegion": (nls.SimpleTrustRegion, {11, 21}, {21}),
        "SimpleTrustRegion-NLsolve": (
            lambda: nls.SimpleTrustRegion(nlsolve_update_rule=True), {21},
            {21}),
        "SimpleLimitedMemoryBroyden": (nls.SimpleLimitedMemoryBroyden,
                                       {1, 6, 11, 18}, {1, 6, 11, 18, 21}),
    }


# the engines of (b): name -> (algorithm, a Jacobian engine: its lone solves
# must give the batch's NLStats)
def _batch_engines(nls):
    return {
        "SimpleNewtonRaphson": (nls.SimpleNewtonRaphson, True),
        "SimpleBroyden": (nls.SimpleBroyden, False),
        "SimpleKlement": (nls.SimpleKlement, False),
        "SimpleDFSane": (nls.SimpleDFSane, False),
        "SimpleHalley": (nls.SimpleHalley, True),
        "SimpleTrustRegion": (nls.SimpleTrustRegion, True),
        "SimpleTrustRegion-NLsolve": (
            lambda: nls.SimpleTrustRegion(nlsolve_update_rule=True), True),
        "SimpleLimitedMemoryBroyden": (nls.SimpleLimitedMemoryBroyden,
                                       False),
    }


BATCH_GROUPS = {
    "cuBLAS (batched J·v, Jᵀ·v, ring products)": (
        "gemv", "gemm", "xmma", "cutlass", "cublas", "dot_kernel"),
    "cuSOLVER / SVD": ("getrf", "getrs", "gesvd", "cusolver", "syevj"),
    "reductions (norms, flags)": ("reduce",),
    "where (frozen rows)": ("where",),
    "elementwise (residual, steps, Gauss–Jordan)": (
        "elementwise", "vectorized", "unrolled", "copy", "fill", "index",
        "cat", "scatter", "arange")}
LONE_CHECKS = 64
LONE_CHECKS_22 = 16   # (b) and (c), cut from 64 for the script's time


def _stats_dict(stats, i=None):
    keys = ("nf", "njacs", "nfactors", "nsolve", "nsteps")
    if i is None:
        return {k: int(getattr(stats, k)) for k in keys}
    return {k: int(getattr(stats, k)[i]) for k in keys}


def batched_run_report(torch, _backend, run, label, B, card):
    """One batched solve: the first run (counted), then one profiled run
    (its wall the warm wall) with the peak memory of a run.  Returns (solution, the
    record's timing fields)."""
    torch.cuda.synchronize()
    _backend.reset_counters()
    t0 = time.perf_counter()
    sol = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: v for k, v in _backend.LAUNCHES.items() if v}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    # the warm wall is the profiled run's (one run for both, for time)
    prof = profile_device(torch, run, groups=BATCH_GROUPS, host_events=False)
    walls = [prof["profiled_solve_s"]]
    peak = torch.cuda.max_memory_allocated()
    rec = {"B": B, "first_solve_s": first_s, "warm_wall_s_one": walls[0],
           "trajectories_per_s": B / walls[0],
           "slowest_row_steps": int(sol.stats.nsteps.max()),
           "host_reads": sol.counters["host_syncs"],
           "device_idle_share": prof["device_idle_share"],
           "device_busy_ms": prof["device_busy_ms"],
           "device_ms_by_class": prof["device_ms_by_group"],
           "top3_device_ms": prof["top_device_ms"][:3],
           "peak_memory_bytes": peak,
           "peak_memory_over_resident_bytes": peak - base,
           "custom_kernel_launches": launches, "card": card}
    return sol, rec


def _rel_inf(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


def lone_checks(torch, nls, make, base_prob, U0, sol, rows, jacobian,
                lone_prob=None, **kw):
    """Solve the batch's ``rows`` alone (B = 1) on the card: each must give
    the batch's retcode and a root within rel-inf 1e-10 of the batch row's;
    a Jacobian engine also its NLStats.  Returns (failures, the NLStats
    differences of the others, seconds)."""
    t0 = time.perf_counter()
    bad, diffs = [], []
    for i in rows:
        prob = (lone_prob(i) if lone_prob is not None
                else base_prob.remake(u0=U0[i]))
        lone = nls.solve(prob, make(), **kw)
        batch_stats = _stats_dict(sol.stats, i)
        lone_stats = _stats_dict(lone.stats)
        rel = _rel_inf(lone.u.reshape(-1), sol.u[i].reshape(-1))
        if int(lone.retcode) != int(sol.retcode[i]) or not rel <= 1e-10:
            bad.append({"row": int(i), "lone": int(lone.retcode),
                        "batch": int(sol.retcode[i]), "rel_inf": rel})
        if lone_stats != batch_stats:
            diffs.append({"row": int(i), "lone": lone_stats,
                          "batch": batch_stats})
            if jacobian:
                bad.append({"row": int(i), "stats": "differ"})
    torch.cuda.synchronize()
    return bad, diffs, time.perf_counter() - t0


def batched_tier_phase(torch, nls, _backend, card):
    """Phase 22 (see the module docstring)."""
    import numpy as np
    from nonlinearsolve_tpu_torch.models import problems23 as p23
    dev, f64 = torch.device("cuda"), torch.float64
    t_phase = time.perf_counter()
    failed = []
    abstol = 3.0e-13                      # the f64 default
    pick = np.random.default_rng(2213)

    # (a) the simple rows of the 23-problem suite, lone solves (B = 1)
    for row, (make, broken, long) in _simple_rows(nls).items():
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        _backend.reset_counters()
        got, steps, reads = set(), {}, 0
        for tp in p23.PROBLEMS_23:
            if tp.index in long:
                continue
            sol = nls.solve(nls.NonlinearProblem(
                tp.f, torch.tensor(tp.start, dtype=f64, device=dev)),
                make(), maxiters=10000)
            if not float(tp.f(sol.u).abs().max()) <= 1e-4:
                got.add(tp.index)
            steps[tp.index] = sol.stats.nsteps
            reads += sol.counters["host_syncs"]
        launches = {k: v for k, v in _backend.LAUNCHES.items() if v}
        expected = broken - long
        secs = time.perf_counter() - t0
        emit({"phase": "batched_problems23", "row": row,
              "broken": sorted(got), "expected": sorted(expected),
              "in_tests_test_torch_23_simple_long": sorted(long),
              "nsteps": steps, "steps": sum(steps.values()),
              "host_reads": reads, "seconds": secs,
              "ms_per_step": 1e3 * secs / max(sum(steps.values()), 1),
              "custom_kernel_launches": launches, "card": card})
        if got != expected or launches:
            failed.append(f"(a) {row}")

    def starts(x0, B, seed):
        xi = np.random.default_rng(seed).uniform(-1.0, 1.0,
                                                 size=(B, len(x0)))
        return torch.tensor(np.asarray(x0) * (1.0 + 0.1 * xi), dtype=f64,
                            device=dev)

    def success_resid_ok(f, sol):
        ok = sol.retcode == int(nls.ReturnCode.Success)
        if not bool(ok.any()):
            return True, 0.0
        F = torch.func.vmap(lambda u: f(u, None))(sol.u[ok])
        worst = float(F.abs().max())
        return worst <= abstol, worst

    # (b) problem 9 (discrete boundary value), n = 10, 262,144 starts, at
    # maxiters 200 (SimpleKlement needs 1431 steps from the nominal start in
    # the JAX package: its rows all end MaxIters, and bound the phase)
    B = 262144
    tp9 = p23.PROBLEMS_23[8]
    U0 = starts(tp9.start, B, 9)
    base = nls.NonlinearProblem(tp9.f, U0[0])
    rows = pick.choice(B, LONE_CHECKS_22, replace=False)
    for name, (make, jacobian) in _batch_engines(nls).items():
        run = lambda: nls.solve_ensemble(base, make(), u0s=U0,  # noqa: E731
                                         maxiters=200)
        sol, rec = batched_run_report(torch, _backend, run, name, B, card)
        codes = dict(zip(*[t.tolist() for t in torch.unique(
            sol.retcode, return_counts=True)]))
        resid_ok, worst = success_resid_ok(tp9.f, sol)
        bad, diffs, lone_s = lone_checks(torch, nls, make, base, U0, sol,
                                         rows, jacobian, maxiters=200)
        ok = resid_ok and not bad and not rec["custom_kernel_launches"]
        emit({"phase": "batched_problem9", "engine": name, "n": 10,
              "maxiters": 200,
              "retcodes": codes, "success_resid_inf_max": worst,
              "abstol": abstol, "lone_checked": LONE_CHECKS_22,
              "lone_failures": bad, "lone_stats_differences": len(diffs),
              "lone_stats_difference_examples": diffs[:3],
              "lone_seconds": lone_s, **rec, "ok": ok})
        if not ok:
            failed.append(f"(b) {name}")
        del sol

    # (c) problem 10 (discrete integral) lifted to n = 64, 16,384 starts,
    # SimpleLimitedMemoryBroyden on its 27-deep ring
    B = 16384
    t = np.arange(1, 65) / 65.0
    U0 = starts(t * (t - 1.0), B, 10)
    base = nls.NonlinearProblem(p23._discrete_integral, U0[0])
    make = nls.SimpleLimitedMemoryBroyden
    run = lambda: nls.solve_ensemble(base, make(), u0s=U0)  # noqa: E731
    sol, rec = batched_run_report(torch, _backend, run, "lbroyden", B, card)
    codes = dict(zip(*[t_.tolist() for t_ in torch.unique(
        sol.retcode, return_counts=True)]))
    resid_ok, worst = success_resid_ok(p23._discrete_integral, sol)
    rows = pick.choice(B, LONE_CHECKS_22, replace=False)
    bad, diffs, lone_s = lone_checks(torch, nls, make, base, U0, sol, rows,
                                     False)
    ok = resid_ok and not bad and not rec["custom_kernel_launches"]
    emit({"phase": "batched_problem10_n64",
          "engine": "SimpleLimitedMemoryBroyden", "n": 64, "ring": 27,
          "retcodes": codes, "success_resid_inf_max": worst,
          "lone_checked": LONE_CHECKS_22, "lone_failures": bad,
          "lone_stats_differences": len(diffs),
          "lone_stats_difference_examples": diffs[:3],
          "lone_seconds": lone_s, **rec, "ok": ok})
    if not ok:
        failed.append("(c)")
    del sol, U0

    # (d) u² − p, u0 = [1.0], SimpleNewtonRaphson over 1,048,576 values of p
    B = 1 << 20
    ps = torch.linspace(0.5, 10.0, B, dtype=f64, device=dev)
    sq = lambda u, q: u * u - q                            # noqa: E731
    base = nls.NonlinearProblem(sq, torch.ones(1, dtype=f64, device=dev))
    run = lambda: nls.solve_ensemble(                      # noqa: E731
        base, nls.SimpleNewtonRaphson(), ps=ps)
    sol, rec = batched_run_report(torch, _backend, run, "quadratic", B, card)
    err = float((sol.u[:, 0] - ps.sqrt()).abs().max())
    rows = pick.choice(B, LONE_CHECKS, replace=False)
    bad, diffs, lone_s = lone_checks(
        torch, nls, nls.SimpleNewtonRaphson, base, None, sol, rows, True,
        lone_prob=lambda i: base.remake(p=ps[i]))
    all_success = bool((sol.retcode == int(nls.ReturnCode.Success)).all())
    ok = (all_success and err <= 1e-8 and not bad
          and not rec["custom_kernel_launches"])
    emit({"phase": "batched_quadratic_ensemble", "B": B,
          "engine": "SimpleNewtonRaphson", "all_success": all_success,
          "root_inf_distance_to_sqrt_p": err, "limit": 1e-8,
          "lone_checked": LONE_CHECKS, "lone_failures": bad,
          "lone_stats_differences": len(diffs), "lone_seconds": lone_s,
          **rec, "ok": ok})
    if not ok:
        failed.append("(d)")
    del sol

    # (e) the eight bracketing methods on u² − p over (0.1, 5.0)
    left = torch.tensor(0.1, dtype=f64, device=dev)
    right = torch.tensor(5.0, dtype=f64, device=dev)
    for name in ("Bisection", "Falsi", "Ridder", "Brent", "ITP", "Alefeld",
                 "Muller", "ModAB"):
        alg = getattr(nls, name)()
        prob = nls.IntervalNonlinearProblem(sq, (left, right), ps)
        run = lambda: nls.solve(prob, alg)                 # noqa: E731
        sol, rec = batched_run_report(torch, _backend, run, name, B, card)
        codes = dict(zip(*[t_.tolist() for t_ in torch.unique(
            sol.retcode, return_counts=True)]))
        successful = bool(sol.success.all())
        err = float((sol.u - ps.sqrt()).abs().max())
        ok = (successful and err <= 1e-8
              and not rec["custom_kernel_launches"])
        emit({"phase": "batched_bracketing", "method": name,
              "retcodes": codes, "all_successful": successful,
              "root_inf_distance_to_sqrt_p": err, "limit": 1e-8,
              **rec, "ok": ok})
        if not ok:
            failed.append(f"(e) {name}")
        del sol
    # the implicit-function derivative du/dp on the card (ModAB)
    pg = ps.clone().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u = nls.solve(nls.IntervalNonlinearProblem(sq, (left, right), pg)).u
    g, = torch.autograd.grad(u.sum(), pg)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    grad_err = float(((g - 0.5 / ps.sqrt()) / (0.5 / ps.sqrt())).abs().max())
    ok = grad_err <= 1e-8 and g.device.type == "cuda"
    emit({"phase": "batched_bracketing_gradient", "method": "ModAB",
          "B": B, "rel_err_to_half_rsqrt_p": grad_err, "limit": 1e-8,
          "seconds": grad_s, "ok": ok, "card": card})
    if not ok:
        failed.append("(e) gradient")
    del pg, u, g, ps
    emit({"phase": "batched_tier_done",
          "phase_seconds": time.perf_counter() - t_phase, "card": card})
    if failed:
        raise AssertionError(f"batched tier phase failed: {failed}")


def _refusal(fn):
    """The message of the NotImplementedError ``fn()`` raises, else None
    (a refusal is what phase 23 (d) checks for)."""
    try:
        fn()
    except NotImplementedError as exc:
        return str(exc)
    return None


def sensitivity_phase(torch, nls, _backend, brusselator, stencil, spmv,
                      card, flag_prob, flag_alg, prob64, alg64):
    """Phase 23: differentiating through ``solve`` and the A.18 surface on
    the card ((c), the reverse rules of K5, K7 and K8, runs in phases 7, 12
    and 13, on their matrices).  Each run with the launch counters at 0
    just before and read just after.  Returns the phase's record."""
    import numpy as np
    from torch.autograd import forward_ad as fwAD
    from nonlinearsolve_tpu_torch.core import cache as cache_mod
    from nonlinearsolve_tpu_torch.core import sensitivity as sens
    t_phase = time.perf_counter()
    f64 = torch.float64
    dev = flag_prob.u0.device
    out = {"phase": "sensitivity", "card": card}

    def run(fn):
        torch.cuda.synchronize()
        _backend.reset_counters()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, {
            k: v for k, v in _backend.LAUNCHES.items() if v}

    def idle(fn):
        """One more run of ``fn`` under torch.profiler: its wall, the
        device's busy time and idle share."""
        prof = profile_device(torch, fn, groups={}, host_events=False)
        return {k: prof[k] for k in ("profiled_solve_s", "device_busy_ms",
                                     "device_idle_share")}

    # --- (a) the dense branch at n = 2048 = _DENSE_IFT_LIMIT ---------------
    base = brusselator.make_problem(32, f64)
    n = base.u0.numel()
    g = np.random.default_rng(23)
    w = torch.as_tensor(g.standard_normal(tuple(base.u0.shape)), device=dev)
    p0 = base.p.detach().clone()
    eye = torch.eye(4, dtype=f64, device=dev)

    def reverse(alg):
        p = p0.clone().requires_grad_(True)
        sol = nls.solve(base.remake(p=p), alg, abstol=1e-10)
        pbar, = torch.autograd.grad((w * sol.u).sum(), p)
        return sol, pbar, dict(sens.STATS)

    (sol_nr, pbar, st), wall, launches = run(
        lambda: reverse(nls.NewtonRaphson()))
    wdot = []
    fwd_wall = 0.0
    for i in (0, 1):
        def forward(i=i):
            with fwAD.dual_level():
                s = nls.solve(base.remake(p=fwAD.make_dual(p0, eye[i])),
                              nls.NewtonRaphson(), abstol=1e-10)
                return float((w * fwAD.unpack_dual(s.u).tangent).sum())
        val, secs, _ = run(forward)
        wdot.append(val)
        fwd_wall += secs
    fd = []
    for i in range(4):
        h = 1e-4 * abs(float(p0[i]))
        vals = []
        for sgn in (1.0, -1.0):
            s = nls.solve(base.remake(u0=sol_nr.u.detach(),
                                      p=p0 + sgn * h * eye[i]),
                          nls.NewtonRaphson(), abstol=1e-10)
            vals.append(float((w * s.u).sum()))
        fd.append((vals[0] - vals[1]) / (2 * h))
    pb = pbar.cpu().numpy()
    scale = float(np.abs(pb).max())
    fd_rel = float(np.abs(np.array(fd) - pb).max()) / scale
    jvp_rel = [abs(wdot[i] - pb[i]) / abs(pb[i]) for i in (0, 1)]
    a_prof = idle(lambda: reverse(nls.NewtonRaphson()))
    (_, pbar_tr, _), wall_tr, _ = run(lambda: reverse(nls.TrustRegion()))
    (sol_pa, pbar_pa, _), wall_pa, _ = run(lambda: reverse(None))
    tr_rel = float((pbar_tr - pbar).abs().max()) / scale
    pa_rel = float((pbar_pa - pbar).abs().max()) / scale
    out["a_dense"] = {
        "N": 32, "n": n, "dtype": "float64", "abstol": 1e-10,
        "retcode": sol_nr.retcode.name, "nsteps": sol_nr.stats.nsteps,
        "branch": st.get("branch"), "pbar": pb.tolist(),
        "wdot_forward_A_B": wdot, "forward_rel_err": jvp_rel,
        "fd_rel_err": fd_rel, "fd_step_rel": 1e-4,
        "trust_region_rel": tr_rel, "polyalg_rel": pa_rel,
        "polyalg_winner": sol_pa.counters.get("winner"),
        "wall_solve_and_backward_s": wall, "wall_two_forward_s": fwd_wall,
        "wall_trust_region_s": wall_tr, "wall_polyalg_s": wall_pa,
        "profiled_solve_and_backward": a_prof, "launches": launches}
    checks = {
        "(a) Success": sol_nr.retcode == nls.ReturnCode.Success,
        "(a) dense branch": st.get("branch") == "dense",
        "(a) <w, u_dot> = p_bar (rel 1e-10)": max(jvp_rel) <= 1e-10,
        "(a) central differences (rel 1e-5)": fd_rel <= 1e-5,
        "(a) TrustRegion's p_bar (rel 1e-8)": tr_rel <= 1e-8,
        "(a) the polyalgorithm's p_bar (rel 1e-8)": pa_rel <= 1e-8,
        "(a) no kernel launched": not launches,
    }

    # --- (b) the Krylov branch at the flagship's width, f64 --------------
    wb = torch.as_tensor(np.random.default_rng(24).standard_normal(
        tuple(prob64.u0.shape)), device=dev)
    pb0 = prob64.p.detach().clone()

    def krylov():
        p = pb0.clone().requires_grad_(True)
        sol = nls.solve(prob64.remake(p=p), alg64, abstol=1e-4, maxiters=10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pbar, = torch.autograd.grad((wb * sol.u).sum(), p)
        torch.cuda.synchronize()
        return sol, pbar, time.perf_counter() - t0, dict(sens.STATS)

    (sol_b, pbar_b, adjoint_s, st_b), wall_b, launches_b = run(krylov)
    b_prof = idle(krylov)
    fd_b = []
    for i in range(4):
        h = 1e-4 * abs(float(pb0[i]))
        vals = []
        for sgn in (1.0, -1.0):
            s = nls.solve(prob64.remake(u0=sol_b.u.detach(),
                                        p=pb0 + sgn * h * eye[i]), alg64,
                          abstol=1e-8, maxiters=10)
            vals.append(float((wb * s.u).sum()))
        fd_b.append((vals[0] - vals[1]) / (2 * h))
    pbb = pbar_b.cpu().numpy()
    out["b_krylov"] = {
        "N": 512, "n": prob64.u0.numel(), "dtype": "float64",
        "retcode": sol_b.retcode.name, "nsteps": sol_b.stats.nsteps,
        "branch": st_b.get("branch"),
        "gmres_iterations": st_b.get("iterations"),
        "adjoint_rel_residual": st_b.get("rel_residual"),
        "adjoint_met_rtol_1e-8": st_b.get("success"),
        "pbar": pbb.tolist(), "central_differences": fd_b,
        "fd_rel_gap": float(np.abs(np.array(fd_b) - pbb).max())
        / float(np.abs(pbb).max()),
        "wall_solve_and_backward_s": wall_b, "backward_s": adjoint_s,
        "profiled_solve_and_backward": b_prof, "launches": launches_b}
    checks["(b) the polish's Success"] = \
        sol_b.retcode == nls.ReturnCode.Success
    checks["(b) GMRES branch"] = st_b.get("branch") == "gmres"
    checks["(b) K1 in the solve"] = launches_b.get("brusselator_jvp", 0) > 0

    # --- (d) refusals: grad mode through K1 and K4 on the card ------------
    U = flag_prob.u0.detach().clone().requires_grad_(True)
    k1 = _refusal(lambda: stencil.brusselator_jvp(
        U, torch.ones_like(U), flag_prob.p))
    xd = torch.ones(1024, device=dev, requires_grad=True)
    k4 = _refusal(lambda: spmv.dia_spmv(torch.ones((3, 1024), device=dev),
                                        (-1, 0, 1), xd))
    # and a forward-mode tangent through K1 and through CSR.matvec
    T1 = torch.ones_like(flag_prob.u0)
    pat = brusselator.sparsity_pattern(64)
    Cd = pat.with_data(torch.ones(pat.nnz, dtype=f64, device=dev))
    x64 = torch.ones(pat.shape[1], dtype=f64, device=dev)
    with fwAD.dual_level():
        k1_fwd = _refusal(lambda: stencil.brusselator_jvp(
            flag_prob.u0, fwAD.make_dual(T1, T1), flag_prob.p))
        csr_fwd = _refusal(lambda: Cd.matvec(fwAD.make_dual(x64, x64)))
    out["d_refusals"] = {"K1": k1, "K4": k4, "K1_tangent": k1_fwd,
                         "csr_matvec_tangent": csr_fwd}
    checks["(d) K1 refuses grad"] = k1 is not None and "K1" in k1
    checks["(d) K4 refuses grad"] = k4 is not None and "K4" in k4
    checks["(d) K1 refuses a tangent"] = k1_fwd is not None \
        and "K1" in k1_fwd
    checks["(d) CSR.matvec refuses a tangent"] = csr_fwd is not None \
        and "csr_spmv" in csr_fwd

    # --- (e) the A.18 surface on the f32 flagship -------------------------
    kw = {"abstol": 5.0, "maxiters": 30}
    ref, ref_s, ref_launches = run(lambda: nls.solve(flag_prob, flag_alg,
                                                     **kw))

    def iterate():
        cache = nls.init(flag_prob, flag_alg, **kw)
        cache.step(2)
        return cache, cache.solve()

    (cache, it_sol), it_s, it_launches = run(iterate)
    e_prof = idle(iterate)
    # reinit warm-starts the dense f64 Newton of (a) at A + 1 % from its
    # root (the f32 flagship sits on its f32 floor, where a start near
    # the root is no better than u0)
    p2 = p0.clone()
    p2[0] = p2[0] * 1.01
    cold, cold_s, _ = run(lambda: nls.solve(base.remake(p=p2),
                                            nls.NewtonRaphson(),
                                            abstol=1e-10))
    dense_cache = nls.init(base, nls.NewtonRaphson(), abstol=1e-10)
    dense_root = dense_cache.solve().u
    warm, warm_s, _ = run(lambda: dense_cache.reinit(u0=dense_root,
                                                     p=p2).solve())
    traced, traced_s, _ = run(lambda: nls.solve(
        flag_prob, flag_alg, store_trace=True, time_phases=True, **kw))
    tm = traced.timer
    phase_sum = sum(tm[k] for k in ("jacobian", "descent", "linesearch",
                                    "other"))
    bounded_prob = nls.NonlinearProblem(base.f, base.u0, p0, lb=0.0)
    bounded, bounded_s, _ = run(lambda: nls.solve(
        bounded_prob, nls.TrustRegion(), abstol=1e-10))
    bounded_gap = float((bounded.u - sol_nr.u.detach()).abs().max())
    # a budget stops a solve that has done work: the bounded TrustRegion
    # takes more steps than one chunk, and half its first chunk's wall
    # (from the solve just timed) lets that chunk run and stops the next;
    # the same cache then resumes and gives the solve's root bit for bit.
    # A stop returns the safe-best iterate and the next solve resumes
    # from it, as in the JAX package, which may take other steps; a mode
    # that keeps no best iterate resumes where the stop left off
    chunk = cache_mod._STEP_CHUNK
    no_best = {"abstol": 1e-10, "termination_condition":
               nls.AbsNormSafeTerminationMode(norm="linf",
                                              max_stalled_steps=32)}
    whole, whole_s, _ = run(lambda: nls.solve(
        bounded_prob, nls.TrustRegion(), **no_best))
    budget_set = 0.5 * whole_s * chunk / max(whole.stats.nsteps, 1)
    budget_cache = nls.init(bounded_prob, nls.TrustRegion(), **no_best)
    budget, budget_s, _ = run(
        lambda: budget_cache.solve(maxtime=budget_set))
    resumed = budget_cache.solve()
    out["e_a18"] = {
        "iterator": {"retcode": it_sol.retcode.name,
                     "stats": vars(it_sol.stats),
                     "solve_stats": vars(ref.stats),
                     "root_bit_equal": bool(torch.equal(it_sol.u, ref.u)),
                     "wall_s": it_s, "solve_wall_s": ref_s,
                     "profiled": e_prof,
                     "launches": it_launches,
                     "solve_launches": ref_launches},
        "reinit_warm": {"problem": "dense Brusselator N=32 f64, "
                        "NewtonRaphson, abstol 1e-10, A + 1 %",
                        "p_A": float(p2[0]), "retcode": warm.retcode.name,
                        "nsteps": warm.stats.nsteps, "wall_s": warm_s,
                        "cold_retcode": cold.retcode.name,
                        "cold_nsteps": cold.stats.nsteps,
                        "cold_wall_s": cold_s},
        "trace_and_timer": {"trace_n": traced.trace.n,
                            "nsteps": traced.stats.nsteps,
                            "fnorm": traced.trace.fnorm[
                                :traced.trace.n].tolist(),
                            "timer": tm, "phase_sum_s": phase_sum,
                            "wall_s": traced_s,
                            "timer_share_of_wall": tm["total"] / traced_s},
        "maxtime": {"problem": "the bounded dense Brusselator below, "
                    "AbsNormSafe termination (linf)",
                    "step_chunk": chunk, "maxtime_s": budget_set,
                    "retcode": budget.retcode.name,
                    "nsteps": budget.stats.nsteps, "wall_s": budget_s,
                    "unbudgeted_nsteps": whole.stats.nsteps,
                    "unbudgeted_wall_s": whole_s,
                    "resumed_retcode": resumed.retcode.name,
                    "resumed_nsteps": resumed.stats.nsteps},
        "bounded": {"N": 32, "lb": 0.0, "alg": "TrustRegion",
                    "retcode": bounded.retcode.name,
                    "nsteps": bounded.stats.nsteps,
                    "gap_to_unbounded_root": bounded_gap,
                    "wall_s": bounded_s}}
    checks.update({
        "(e) iterator = solve: retcode": it_sol.retcode == ref.retcode
        == nls.ReturnCode.Success,
        "(e) iterator = solve: NLStats": it_sol.stats == ref.stats,
        "(e) iterator = solve: root bit for bit":
            bool(torch.equal(it_sol.u, ref.u)),
        "(e) reinit warm-starts": warm.success
        and warm.stats.nsteps < cold.stats.nsteps,
        "(e) trace of every step": traced.trace.n == traced.stats.nsteps,
        "(e) tracing and timing change no root":
            bool(torch.equal(traced.u, ref.u)),
        "(e) phases sum to the timer's total":
            abs(phase_sum - tm["total"]) <= 1e-6 * tm["total"],
        "(e) phases within 10 % of the wall":
            abs(tm["total"] - traced_s) <= 0.1 * traced_s,
        "(e) the solve is longer than one chunk":
            whole.stats.nsteps > chunk,
        "(e) maxtime stops a solve that has done work":
            budget.retcode == nls.ReturnCode.MaxTime
            and 0 < budget.stats.nsteps < whole.stats.nsteps,
        "(e) the stopped cache resumes to the solve's root":
            resumed.retcode == whole.retcode == nls.ReturnCode.Success
            and resumed.stats == whole.stats
            and bool(torch.equal(resumed.u, whole.u)),
        "(e) bounded TrustRegion Success":
            bounded.retcode == nls.ReturnCode.Success,
        "(e) bounded root within 1e-8 of the unbounded": bounded_gap <= 1e-8,
    })
    checks = {k: bool(v) for k, v in checks.items()}
    out["checks"] = checks
    out["seconds"] = time.perf_counter() - t_phase
    out["ok"] = all(checks.values())
    emit(out)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"phase 23 failed: {failed}")
    return out


def _fd5(value, x0, h):
    """The fourth-order central difference of ``value`` at ``x0``."""
    return (-value(x0 + 2 * h) + 8 * value(x0 + h) - 8 * value(x0 - h)
            + value(x0 - 2 * h)) / (12 * h)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def continuation_phase(torch, nls, _backend, card, flag_prob, flag_alg):
    """Phase 24: continuation, steady states, an SCC chain, a user
    algorithm and the SciPy bridge on the card (see the module docstring).
    Each run with the launch counters at 0 just before and read just
    after."""
    import numpy as np
    from torch.autograd import forward_ad as fwAD
    from nonlinearsolve_tpu_torch.core.autodiff import jacfwd
    from nonlinearsolve_tpu_torch.models.bratu import bratu_2d
    from nonlinearsolve_tpu_torch.ops.linear_solve import solve_dense
    from nonlinearsolve_tpu_torch.solvers.custom import run_fixed_point_loop
    t_phase = time.perf_counter()
    f64 = torch.float64
    dev = flag_prob.u0.device
    failed = []

    def check(name, ok):
        if not ok:
            failed.append(name)

    def run(fn):
        torch.cuda.synchronize()
        _backend.reset_counters()
        syncs0 = _backend.HOST_SYNCS["n"]
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, {
            "launches": {k: v for k, v in _backend.LAUNCHES.items() if v},
            "host_reads": _backend.HOST_SYNCS["n"] - syncs0}

    def stats_of(sol):
        return [sol.stats.nf, sol.stats.njacs, sol.stats.nsteps]

    NR = nls.NewtonRaphson
    methods = {
        "sweep": lambda: nls.HomotopySweep(inner=NR()),
        "kantorovich": lambda: nls.KantorovichHomotopy(inner=NR()),
        "arclength": lambda: nls.ArcLengthContinuation(inner=NR()),
        "polyalg": lambda: nls.HomotopyPolyAlgorithm()}

    def H(u, p, lam):
        return bratu_2d(u, lam)

    def Hp(u, p, lam):
        return bratu_2d(u, lam * p)

    # --- (a) the Bratu λ-continuation at config 3's width and at 4× -------
    for N in CONTINUATION_SIZES:
        prob = nls.HomotopyProblem(H, torch.zeros((N, N), dtype=f64,
                                                  device=dev), None,
                                   lambdaspan=(0.0, 6.5))
        roots = {}
        for name, make in methods.items():
            solve = lambda: nls.solve(prob, make(), abstol=1e-8)  # noqa
            sol, wall, counts = run(solve)
            # the warm wall is the profiled solve's (one run, for time)
            prof = profile_device(torch, solve, groups=CONTINUATION_GROUPS,
                                  host_events=False)
            warm = prof["profiled_solve_s"]
            busy = prof["device_busy_ms"]
            shares = ({g: ms / busy for g, ms in
                       prof["device_ms_by_group"].items()}
                      if isinstance(busy, float) else "not measured")
            resid = float(bratu_2d(sol.u, 6.5).abs().max())
            jax_stats, jax_lam, jax_max, jax_sum = JAX_CONTINUATION[N][name]
            roots[name] = sol.u
            lam, max_u, sum_u = (float(sol.original), float(sol.u.max()),
                                 float(sol.u.sum()))
            emit({"phase": "continuation", "case": f"bratu{N}_{name}",
                  "retcode": sol.retcode.name, "stats": stats_of(sol),
                  "jax_stats": jax_stats, "lam_last": lam,
                  "jax_lam_last": jax_lam, "resid_inf": resid,
                  "max_u": max_u, "jax_max_u": jax_max, "sum_u": sum_u,
                  "jax_sum_u": jax_sum,
                  "first_wall_s": wall, "warm_wall_s": warm, **counts,
                  "device_idle_share": prof["device_idle_share"],
                  "device_busy_ms": busy, "device_share_by_group": shares,
                  "top_device_ms": prof["top_device_ms"][:6], "card": card})
            check(f"bratu{N} {name}: Success",
                  sol.retcode == nls.ReturnCode.Success)
            check(f"bratu{N} {name}: |H(u, 6.5)|_inf <= 1e-8", resid <= 1e-8)
            check(f"bratu{N} {name}: NLStats {jax_stats} as the JAX "
                  f"package's", stats_of(sol) == jax_stats)
            check(f"bratu{N} {name}: the JAX package's last λ and max u "
                  f"within 1e-10, its Σu within 1e-8",
                  abs(lam - jax_lam) <= 1e-10
                  and abs(max_u - jax_max) <= 1e-10
                  and abs(sum_u - jax_sum) <= 1e-8)
            check(f"bratu{N} {name}: no kernel launched",
                  not counts["launches"])
        spread = max(float((roots[a] - roots[b]).abs().max())
                     for a in roots for b in roots)
        emit({"phase": "continuation", "case": f"bratu{N}_roots",
              "max_pairwise_inf": spread})
        check(f"bratu{N}: the four roots within 1e-9", spread <= 1e-9)
    prob = nls.HomotopyProblem(H, torch.zeros((32, 32), dtype=f64,
                                              device=dev), None,
                               lambdaspan=(0.0, 6.5))
    for name, (code, jax_stats, jax_lam) in JAX_CONTINUATION_FLOOR.items():
        sol, wall, counts = run(lambda: nls.solve(prob, methods[name]()))
        emit({"phase": "continuation", "case": f"bratu32_{name}_floor",
              "retcode": sol.retcode.name, "jax_retcode": code,
              "stats": stats_of(sol), "jax_stats": jax_stats,
              "lam_last": float(sol.original), "jax_lam_last": jax_lam,
              "max_u": float(sol.u.max()), "wall_s": wall, **counts,
              "card": card})
        check(f"bratu32 {name} at the default abstol: the JAX package's "
              f"{code}", sol.retcode.name == code
              and bool(torch.isfinite(sol.u).all()))

    # --- (b) the derivative through a continuation solve -------------------
    for N in CONTINUATION_SIZES:
        w = torch.as_tensor(np.random.default_rng(24).standard_normal(
            (N, N)), device=dev)
        z = torch.zeros((N, N), dtype=f64, device=dev)
        p0 = torch.tensor(1.0, dtype=f64, device=dev)

        def problem(p):
            return nls.HomotopyProblem(Hp, z, p, lambdaspan=(0.0, 6.5))

        def reverse():
            p = p0.clone().requires_grad_(True)
            sol = nls.solve(problem(p), methods["sweep"](), abstol=1e-8)
            pbar, = torch.autograd.grad((w * sol.u).sum(), p)
            return sol, float(pbar)

        def forward():
            with fwAD.dual_level():
                sol = nls.solve(problem(fwAD.make_dual(
                    p0, torch.ones_like(p0))), methods["sweep"](),
                    abstol=1e-8)
                return float((w * fwAD.unpack_dual(sol.u).tangent).sum())

        (sol, pbar), rev_s, _ = run(reverse)
        wdot, fwd_s, _ = run(forward)
        u_star = sol.u.detach()

        def value(q):
            s = nls.solve(nls.NonlinearProblem(
                lambda u, qq: bratu_2d(u, 6.5 * qq), u_star,
                torch.tensor(q, dtype=f64, device=dev)), NR(), abstol=1e-10)
            return float((w * s.u).sum())
        fd = _fd5(value, 1.0, 1e-3)
        emit({"phase": "continuation_derivative", "N": N, "pbar": pbar,
              "forward": wdot, "central_difference": fd,
              "reverse_forward_rel": _rel(pbar, wdot),
              "reverse_fd_rel": _rel(pbar, fd), "reverse_s": rev_s,
              "forward_s": fwd_s, "card": card})
        check(f"(b) N={N}: reverse within 1e-12 of forward",
              _rel(pbar, wdot) <= 1e-12)
        check(f"(b) N={N}: reverse within 1e-6 of central differences",
              _rel(pbar, fd) <= 1e-6)

    # --- (c) steady states ----------------------------------------------
    z32 = torch.zeros((32, 32), dtype=f64, device=dev)
    lam = torch.tensor(3.5, dtype=f64, device=dev)
    nr_root = nls.solve(nls.NonlinearProblem(bratu_2d, z32, lam), NR(),
                        abstol=1e-10).u
    for method in ("rosenbrock23", "tsit5"):
        sol, wall, counts = run(lambda: nls.solve(
            nls.SteadyStateProblem(bratu_2d, z32, lam),
            nls.DynamicSS(method=method)))
        code, jax_stats = JAX_DYNAMIC_SS[method]
        gap = float((sol.u - nr_root).abs().max())
        emit({"phase": "steady_state", "case": f"bratu32_{method}",
              "retcode": sol.retcode.name, "jax_retcode": code,
              "stats": stats_of(sol), "jax_stats": jax_stats,
              "root_gap_to_newton": gap, "wall_s": wall, **counts,
              "card": card})
        check(f"DynamicSS {method}: the JAX package's {code}",
              sol.retcode.name == code)
        if method == "rosenbrock23":
            check("DynamicSS rosenbrock23: within 1e-6 of the Newton root",
                  gap <= 1e-6)
    ref, ref_s, ref_counts = run(lambda: nls.solve(
        flag_prob, flag_alg, abstol=5.0, maxiters=30))
    ss = nls.SteadyStateProblem(flag_prob.f, flag_prob.u0, flag_prob.p)
    sol, wall, counts = run(lambda: nls.solve(
        ss, nls.SSRootfind(flag_alg), abstol=5.0, maxiters=30))
    k1 = counts["launches"].get("brusselator_jvp", 0)
    emit({"phase": "steady_state", "case": "flagship_ssrootfind",
          "retcode": sol.retcode.name, "stats": vars(sol.stats),
          "nonlinear_problem_stats": vars(ref.stats),
          "root_bit_equal": bool(torch.equal(sol.u, ref.u)),
          "k1_launches": k1, "jvp": sol.counters["jvp"], "wall_s": wall,
          "nonlinear_problem_wall_s": ref_s,
          "host_reads": counts["host_reads"], "card": card})
    check("SSRootfind flagship: the NonlinearProblem's root bit for bit",
          bool(torch.equal(sol.u, ref.u)))
    check("SSRootfind flagship: its retcode and NLStats",
          sol.retcode == ref.retcode and sol.stats == ref.stats)
    check("SSRootfind flagship: K1 launches == Jacobian products > 0",
          k1 == sol.counters["jvp"] == ref_counts["launches"].get(
              "brusselator_jvp", -1) > 0)

    # --- (d) an SCC chain -----------------------------------------------
    N = 32
    wc = torch.as_tensor(np.random.default_rng(24).standard_normal(
        3 * N * N), device=dev)

    def jac_of(q):
        u1, lam_ = q
        return jacfwd(lambda v: bratu_2d(v.reshape(N, N), lam_)
                      .reshape(-1))(u1.reshape(-1))

    def neg_exp(q):
        return -torch.exp(q[0]).reshape(-1)

    def chain(p):
        return nls.SCCNonlinearProblem(
            [nls.NonlinearProblem(bratu_2d, z32, p),
             nls.LinearSCCBlock(A=jac_of, b=neg_exp),
             nls.HomotopyProblem(Hp, z32, None)],
            explicitfuns=[None, lambda q, sols: (sols[0].u, q),
                          lambda q, sols: q + sols[0].u.mean()], p=p)

    scc_alg = nls.SCCAlg(nlalg=NR())
    block_poly = nls.HomotopyPolyAlgorithm(stages=(
        nls.HomotopySweep(inner=NR()), nls.ArcLengthContinuation(inner=NR())))
    sol, wall, counts = run(lambda: nls.solve(chain(lam), scc_alg,
                                              abstol=1e-10))
    lone1 = nls.solve(nls.NonlinearProblem(bratu_2d, z32, lam), NR(),
                      abstol=1e-10)
    x2, _ok = solve_dense(jac_of((lone1.u, lam)), neg_exp((lone1.u,)))
    lone3 = nls.solve(nls.HomotopyProblem(Hp, z32, lam + lone1.u.mean()),
                      block_poly, abstol=1e-10)
    lone_stats = [lone1.stats.nf + lone3.stats.nf,
                  lone1.stats.njacs + lone3.stats.njacs,
                  lone1.stats.nsteps + lone3.stats.nsteps]
    blocks = sol.original
    equal = [bool(torch.equal(blocks[0].u, lone1.u)),
             bool(torch.equal(blocks[1].u, x2)),
             bool(torch.equal(blocks[2].u, lone3.u))]

    def scc_reverse():
        p = lam.clone().requires_grad_(True)
        s = nls.solve(chain(p), scc_alg, abstol=1e-10)
        pbar, = torch.autograd.grad((wc * s.u).sum(), p)
        return float(pbar)

    def scc_forward():
        with fwAD.dual_level():
            s = nls.solve(chain(fwAD.make_dual(lam, torch.ones_like(lam))),
                          scc_alg, abstol=1e-10)
            return float((wc * fwAD.unpack_dual(s.u).tangent).sum())

    pbar, rev_s, _ = run(scc_reverse)
    wdot, fwd_s, _ = run(scc_forward)
    fd = _fd5(lambda q: float((wc * nls.solve(
        chain(torch.tensor(q, dtype=f64, device=dev)), scc_alg,
        abstol=1e-10).u).sum()), 3.5, 3.5e-3)
    emit({"phase": "scc_chain", "N": N, "retcode": sol.retcode.name,
          "stats": stats_of(sol), "lone_stats_sum": lone_stats,
          "blocks_equal_lone": equal, "pbar": pbar, "forward": wdot,
          "central_difference": fd, "reverse_forward_rel": _rel(pbar, wdot),
          "reverse_fd_rel": _rel(pbar, fd), "wall_s": wall, **counts,
          "reverse_s": rev_s, "forward_s": fwd_s, "card": card})
    check("SCC: Success", sol.retcode == nls.ReturnCode.Success)
    check("SCC: each block's u equal to its lone solve", all(equal))
    check("SCC: NLStats the sum of the blocks'", stats_of(sol) == lone_stats)
    check("SCC: reverse within 1e-12 of forward", _rel(pbar, wdot) <= 1e-12)
    check("SCC: reverse within 1e-6 of central differences",
          _rel(pbar, fd) <= 1e-6)

    # --- (e) a user algorithm and the SciPy bridge ----------------------
    class Richardson:
        """tests/test_interfaces.py's run_flat fixed-point algorithm."""
        name = "Richardson"

        def run_flat(self, ctx, term_cfg, u0_flat, abstol, reltol,
                     maxiters):
            return run_fixed_point_loop(
                lambda u, fu, state: (u - 0.3 * fu, state), ctx, term_cfg,
                u0_flat, abstol, reltol, maxiters)

    sol, wall, counts = run(lambda: nls.solve(nls.NonlinearProblem(
        lambda u, p: u + 0.3 * torch.tanh(u) - p,
        torch.zeros(5, dtype=f64, device=dev),
        0.7 * torch.ones(5, dtype=f64, device=dev)), Richardson(),
        maxiters=500))
    resid = float(sol.resid.abs().max())
    emit({"phase": "user_algorithm", "retcode": sol.retcode.name,
          "stats": stats_of(sol), "resid_inf": resid, "on_card": sol.u.is_cuda,
          "wall_s": wall, **counts, "card": card})
    check("run_flat: Success on the card",
          sol.retcode == nls.ReturnCode.Success and sol.u.is_cuda)
    check("run_flat: |F|_inf < 1e-10", resid < 1e-10)
    z16 = torch.zeros((16, 16), dtype=f64, device=dev)
    bprob = nls.NonlinearProblem(bratu_2d, z16, lam)
    nr16 = nls.solve(bprob, NR(), abstol=1e-10).u
    sol, wall, counts = run(lambda: nls.solve(bprob, nls.SciPyRoot("hybr")))
    gap = float((sol.u - nr16).abs().max())
    emit({"phase": "scipy_bridge", "method": "hybr", "N": 16,
          "retcode": sol.retcode.name, "nf": sol.stats.nf,
          "root_gap_to_newton": gap, "on_card": sol.u.is_cuda,
          "wall_s": wall, **counts, "card": card})
    check("SciPyRoot hybr: Success", sol.retcode == nls.ReturnCode.Success)
    check("SciPyRoot hybr: within 1e-8 of NewtonRaphson", gap <= 1e-8)
    check("SciPyRoot hybr: sol.u on the card", sol.u.is_cuda)

    emit({"phase": "continuation_timing",
          "phase_seconds": time.perf_counter() - t_phase, "card": card})
    if failed:
        raise AssertionError(f"phase 24 failed: {failed}")


def sorted_roots(u):
    """The rows of a root set in an order that does not depend on the
    run: by each column's real and imaginary parts rounded to 1e-6."""
    import numpy as np
    u = np.atleast_2d(u)
    keys = []
    for j in reversed(range(u.shape[1])):
        keys += [np.round(u[:, j].imag, 6), np.round(u[:, j].real, 6)]
    return u[np.lexsort(keys)]


def quadratic_system(torch, n, seed, device):
    """Phase 25 (e)'s seeded dense quadratic system on one path's complex
    state: f_i(x) = Σ A_ijk x_j x_k + Σ B_ij x_j + c_i (numpy seed
    ``seed``), total degree 2 in each equation."""
    import numpy as np
    rng = np.random.default_rng(seed)
    A = torch.tensor(rng.standard_normal((n, n, n)) / n, device=device)
    B = torch.tensor(rng.standard_normal((n, n)) / np.sqrt(n), device=device)
    c = torch.tensor(rng.standard_normal(n), device=device)

    def f(x, p=None):
        return (torch.einsum("ijk,j,k->i", A.to(x.dtype), x, x)
                + B.to(x.dtype) @ x + c.to(x.dtype))
    return f


def poly_cpu_reference(argv):
    """``--poly-reference N SEED``: the port's all-roots solve of the
    seeded quadratic system on the CPU, one γ (the run that phase 25 (e)
    holds the card's to), printed as one JSON line."""
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import nonlinearsolve_tpu_torch as nls
    from nonlinearsolve_tpu_torch.solvers.poly_homotopy import (
        PolynomialHomotopy, solve_polynomial)
    i = argv.index("--poly-reference")
    n, seed = int(argv[i + 1]), int(argv[i + 2])
    torch.set_num_threads(4)
    f = quadratic_system(torch, n, seed, "cpu")
    t0 = time.perf_counter()
    sol = solve_polynomial(nls.NonlinearProblem(
        f, torch.zeros(n, dtype=torch.float64)), PolynomialHomotopy(
            degrees=(2,) * n), gamma_retries=1)
    ends, ok = sol.original
    print(json.dumps({"distinct_roots": len(sol.u),
                      "paths_ok": int(ok.sum()), "nsteps": sol.stats.nsteps,
                      "loop_steps": sol.counters["loop_steps"],
                      "seconds": time.perf_counter() - t0}))
    return 0


def a33_phase(torch, nls, _backend, brusselator, fft_poisson_preconditioner,
              card):
    """Phase 25: pytree, 0-d and complex states, normal-form Krylov least
    squares, the polynomial drivers and the C.3 / C.4 repairs on the card
    (see the module docstring).  Each run with the launch counters at 0
    just before and read just after."""
    import numpy as np
    from nonlinearsolve_tpu_torch.ops import krylov
    from nonlinearsolve_tpu_torch.solvers import poly_homotopy as ph
    t_phase = time.perf_counter()
    f64, c128 = torch.float64, torch.complex128
    dev = torch.device("cuda")
    failed = []

    def check(name, ok):
        if not ok:
            failed.append(name)

    def run(fn):
        torch.cuda.synchronize()
        _backend.reset_counters()
        syncs0 = _backend.HOST_SYNCS["n"]
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, {
            "launches": {k: v for k, v in _backend.LAUNCHES.items() if v},
            "host_reads": _backend.HOST_SYNCS["n"] - syncs0}

    def stats_of(sol):
        s = sol.stats
        return [int(s.nf), int(s.njacs), int(s.nfactors), int(s.nsolve),
                int(s.nsteps)]

    # the CPU reference of (e)'s quadratic system runs beside the card's
    # checks, in a process of its own that prints its JSON (stopped on any
    # failure below); the walls and idle shares are taken after it ends
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--poly-reference",
         str(POLY_N), str(POLY_SEED)], stdout=subprocess.PIPE, text=True)
    try:
        _a33_cases(torch, nls, _backend, brusselator,
                   fft_poisson_preconditioner, card, np, krylov, ph, f64,
                   c128, dev, check, run, stats_of, child)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
    emit({"phase": "a33_timing", "phase_seconds":
          time.perf_counter() - t_phase, "card": card})
    if failed:
        raise AssertionError(f"phase 25 failed: {failed}")


def _a33_cases(torch, nls, _backend, brusselator, fft_poisson_preconditioner,
               card, np, krylov, ph, f64, c128, dev, check, run, stats_of,
               child):
    """The cases of phase 25, in order (a)–(f); each line carries the
    seconds since they began (``phase_t_s``).  The warm walls and device
    profiles of (b), (d) and (e)'s n = 10 system are taken after the CPU
    reference has ended (``timed``), so that no other process loads the
    host while they run; the first walls run beside it."""
    t_start = time.perf_counter()
    timed = []

    def stamped(obj):
        emit({**obj, "phase_t_s": time.perf_counter() - t_start})

    # --- (a) pytree and 0-d states ------------------------------------
    N = 32
    shaped = brusselator.make_problem(N, f64)
    p = shaped.p
    U0 = shaped.u0

    def f_dict(S, q):
        F = brusselator.brusselator_2d(torch.stack([S["u"], S["v"]], -1), q)
        return {"u": F[..., 0], "v": F[..., 1]}

    def f_flat(w, q):
        S = {"u": w[:N * N].reshape(N, N), "v": w[N * N:].reshape(N, N)}
        F = f_dict(S, q)
        return torch.cat([F["u"].reshape(-1), F["v"].reshape(-1)])
    d0 = {"u": U0[..., 0].clone(), "v": U0[..., 1].clone()}
    w0 = torch.cat([d0["u"].reshape(-1), d0["v"].reshape(-1)])
    real_root = None
    for name in ("NewtonRaphson", "Broyden"):
        alg = getattr(nls, name)
        dsol, wall, counts = run(lambda: nls.solve(
            nls.NonlinearProblem(f_dict, d0, p), alg(), abstol=1e-10))
        fsol = nls.solve(nls.NonlinearProblem(f_flat, w0, p), alg(),
                         abstol=1e-10)
        droot = torch.cat([dsol.u["u"].reshape(-1), dsol.u["v"].reshape(-1)])
        gap_flat = float((droot - fsol.u).abs().max())
        rec = {"phase": "a33_pytree", "case": f"brusselator{N}_dict",
               "alg": name, "retcode": dsol.retcode.name,
               "stats": stats_of(dsol), "flat_stats": stats_of(fsol),
               "root_gap_to_flat": gap_flat, "wall_s": wall, **counts}
        if name == "NewtonRaphson":
            # Broyden leaves this start Unstable (its flat solve too)
            check(f"(a) {name} dict: Success", dsol.success)
        check(f"(a) {name} dict: the flat solve's retcode and NLStats",
              dsol.retcode == fsol.retcode
              and stats_of(dsol) == stats_of(fsol))
        check(f"(a) {name} dict: root within 1e-12 of the flat solve's",
              gap_flat <= 1e-12)
        check(f"(a) {name} dict: leaves on the card, (32, 32) each",
              dsol.u["u"].is_cuda and tuple(dsol.u["v"].shape) == (N, N))
        if name == "NewtonRaphson":
            ssol = nls.solve(shaped, alg(), abstol=1e-10)
            real_root = ssol.u
            gap = float((torch.stack([dsol.u["u"], dsol.u["v"]], -1)
                         - ssol.u).abs().max())
            rec.update(shaped_stats=stats_of(ssol),
                       root_gap_to_shaped=gap)
            check("(a) NewtonRaphson dict: the shaped (N, N, 2) solve's "
                  "NLStats, root within 1e-12",
                  stats_of(ssol) == stats_of(dsol) and gap <= 1e-12)
        stamped({**rec, "card": card})
    zsol, wall, counts = run(lambda: nls.solve(nls.NonlinearProblem(
        lambda u, q: u * u - q, torch.tensor(1.0, dtype=f64, device=dev),
        2.0), nls.NewtonRaphson()))
    stamped({"phase": "a33_pytree", "case": "zero_dim", "retcode":
          zsol.retcode.name, "stats": stats_of(zsol), "u": float(zsol.u),
          "shape": list(zsol.u.shape), "wall_s": wall, **counts,
          "card": card})
    check("(a) 0-d: Success, shape (), √2 within 1e-15",
          zsol.success and zsol.u.shape == ()
          and abs(float(zsol.u) - 2 ** 0.5) <= 1e-15 and zsol.u.is_cuda)

    # --- (b) complex dense ------------------------------------------------
    cubic = nls.NonlinearProblem(
        lambda u, q: u ** 3 - q,
        torch.tensor([-0.8 + 1.5j], dtype=c128, device=dev), 8.0 + 0j)
    for name in ("NewtonRaphson", "Broyden", "Klement", None):
        sol, wall, counts = run(lambda: nls.solve(
            cubic, None if name is None else getattr(nls, name)()))
        jret, jstats = JAX_COMPLEX["cubic"][name]
        err = abs(complex(sol.u[0]) - 2 * np.exp(2j * np.pi / 3))
        stamped({"phase": "a33_complex", "case": "cubic", "alg": name or
              "default", "retcode": sol.retcode.name,
              "stats": stats_of(sol), "jax_stats": jstats,
              "root_err": err, "wall_s": wall, **counts, "card": card})
        check(f"(b) cubic {name}: the JAX package's retcode and NLStats",
              int(sol.retcode) == jret and stats_of(sol) == jstats)
        check(f"(b) cubic {name}: root within 1e-12", err <= 1e-12)
    gen = np.random.default_rng(0)
    pert = torch.tensor(gen.standard_normal(tuple(U0.shape)), device=dev)
    cprob = nls.NonlinearProblem(brusselator.brusselator_2d,
                                 U0 + 1e-3j * pert, p)
    sol, wall, counts = run(lambda: nls.solve(cprob, nls.NewtonRaphson(),
                                              abstol=1e-10))
    jret, jstats = JAX_COMPLEX["complex_brusselator32"]
    gap = float((sol.u.real - real_root).abs().max())
    imag = float(sol.u.imag.abs().max())
    timed.append(({"phase": "a33_complex", "case": "complex_brusselator32",
                   "unknowns": sol.u.numel(), "dtype": "complex128",
                   "retcode": sol.retcode.name, "stats": stats_of(sol),
                   "jax_stats": jstats, "max_real_gap": gap,
                   "max_imag": imag, "first_wall_s": wall, **counts,
                   "card": card},
                  lambda: nls.solve(cprob, nls.NewtonRaphson(),
                                    abstol=1e-10), CONTINUATION_GROUPS))
    check("(b) complex Brusselator: the JAX package's retcode and NLStats",
          int(sol.retcode) == jret and stats_of(sol) == jstats)
    check("(b) complex Brusselator: Re u within 1e-10 of the real root, "
          "|Im u| under 1e-10", gap <= 1e-10 and imag <= 1e-10)

    # --- (c) complex least squares and Krylov ---------------------------
    ts = torch.linspace(0.0, 1.0, 8, dtype=f64, device=dev)
    e = torch.exp(1j * 2 * np.pi * ts)
    sol, wall, counts = run(lambda: nls.solve(
        nls.NonlinearLeastSquaresProblem(
            lambda u, q: u[0] * e - q,
            torch.tensor([0.5 + 0.1j], dtype=c128, device=dev),
            (2.0 + 1.0j) * e), nls.GaussNewton()))
    jret, jstats = JAX_COMPLEX["complex_nlls"]
    err = abs(complex(sol.u[0]) - (2.0 + 1.0j))
    stamped({"phase": "a33_complex", "case": "complex_nlls",
          "retcode": sol.retcode.name, "stats": stats_of(sol),
          "jax_stats": jstats, "root_err": err, "wall_s": wall, **counts,
          "card": card})
    check("(c) complex NLLS: the JAX package's retcode and NLStats, root "
          "within 1e-12", int(sol.retcode) == jret
          and stats_of(sol) == jstats and err <= 1e-12)
    n = 4096
    g = torch.Generator(device="cpu").manual_seed(1)
    A = ((torch.randn((n, n), dtype=c128, generator=g) / np.sqrt(n))
         + 3 * torch.eye(n, dtype=c128)).to(dev)
    b = torch.randn(n, dtype=c128, generator=g).to(dev)
    x_lu, lu_s, _ = run(lambda: torch.linalg.solve(A, b))
    for method in ("gmres", "bicgstab"):
        res, wall, counts = run(lambda: krylov.solve_krylov(
            method, lambda v: A @ v, b, rtol=1e-12, maxiter=2000))
        gap = float((res.x - x_lu).abs().max())
        stamped({"phase": "a33_complex", "case": f"krylov_{method}", "n": n,
              "success": res.success, "iterations": res.iterations,
              "residual_norm": float(res.residual_norm),
              "max_gap_to_lu": gap, "wall_s": wall, "lu_wall_s": lu_s,
              **counts, "card": card})
        check(f"(c) complex {method}: converged, within 1e-10 of LU",
              res.success and gap <= 1e-10)

    # --- (d) normal-form Krylov least squares ---------------------------
    # fit the state whose residual is a seeded target's, with a Tikhonov
    # block: r(u) = [F(u) − F(u_t); λ(u − u_t)], 2n × n, zero at u_t
    Nd, lam = 128, 1e5
    prob_d = brusselator.make_problem(Nd, f64)
    gd = torch.Generator(device="cpu").manual_seed(0)
    u_t = prob_d.u0 * (1 + 0.1 * torch.rand(tuple(prob_d.u0.shape),
                                            generator=gd, dtype=f64).to(dev))
    F_t = brusselator.brusselator_2d(u_t, prob_d.p)

    def stacked(u, q):
        return torch.cat([(brusselator.brusselator_2d(u, q) - F_t).reshape(-1),
                          lam * (u - u_t).reshape(-1)])
    lsq = nls.NonlinearLeastSquaresProblem(stacked, prob_d.u0.clone(),
                                           prob_d.p)
    gn = nls.GaussNewton(linsolve=nls.LinearSolver(
        method="cg", krylov_maxiter=20000))
    # abstol 1e-6: the F block's rounding floor at 128² (α/h² ≈ 1.6e5)
    sol, wall, counts = run(lambda: nls.solve(lsq, gn, abstol=1e-6,
                                              maxiters=20))
    r = stacked(sol.u, prob_d.p)
    _, vjp = torch.func.vjp(lambda v: stacked(v, prob_d.p), sol.u)
    jtr = float(vjp(r)[0].abs().max())
    _, vjp0 = torch.func.vjp(lambda v: stacked(v, prob_d.p), prob_d.u0)
    jtr0 = float(vjp0(stacked(prob_d.u0, prob_d.p))[0].abs().max())
    gap = float((sol.u - u_t).abs().max())
    stamped({"phase": "a33_normal_form", "N": Nd, "rows": r.numel(),
          "unknowns": sol.u.numel(), "lambda": lam, "linsolve": "cg",
          "retcode": sol.retcode.name, "stats": stats_of(sol),
          "krylov_iters": sol.counters["krylov_iters"],
          "jvp_products": sol.counters["jvp"], "jtr_inf": jtr,
          "jtr_inf_at_u0": jtr0, "resid_norm": float(r.norm()),
          "gap_to_target": gap, "first_wall_s": wall, **counts,
          "card": card})
    timed.append(({"phase": "a33_normal_form", "case": "warm", "N": Nd,
                   "krylov_iters": sol.counters["krylov_iters"],
                   "card": card},
                  lambda: nls.solve(lsq, gn, abstol=1e-6, maxiters=20),
                  None))
    check("(d) normal-form GaussNewton: Success at u_t within 1e-10",
          sol.success and gap <= 1e-10)
    check("(d) normal-form GaussNewton: ‖Jᵀr‖∞ down by 1e-8 or more",
          sol.counters["krylov_iters"] > 0 and jtr <= 1e-8 * jtr0)

    # --- (e) polynomial continuation ------------------------------------
    jax_systems = {
        "cubic": (lambda x, q: torch.stack([x[0] ** 3 - 1.0]), [1.0], None,
                  (3,), {}),
        "system2x2": (lambda x, q: torch.stack([x[0] ** 2 + x[1] ** 2 - 5.0,
                                                x[0] * x[1] - 2.0]),
                      [1.0, 1.0], None, (2, 2), {"real_only": True}),
        "parametrized": (lambda x, q: torch.stack([x[0] ** 2 - q]), [1.0],
                         9.0, (2,), {"real_only": True}),
        "wilkinson6": (lambda x, q: torch.stack([
            (x[0] - 1) * (x[0] - 2) * (x[0] - 3) * (x[0] - 4) * (x[0] - 5)
            * (x[0] - 6)]), [0.0], None, (6,), {"real_only": True}),
    }
    for name, (f, u0, q, degrees, kw) in jax_systems.items():
        alg = ph.PolynomialHomotopy(
            degrees=degrees, **({"dt_initial": 0.01}
                                if name == "wilkinson6" else {}))
        out = {}
        for d in (dev, "cpu"):
            sol = ph.solve_polynomial(nls.NonlinearProblem(
                f, torch.tensor(u0, dtype=f64, device=d), q), alg, **kw)
            out[str(d)] = sol
        g, c = out[str(dev)], out["cpu"]
        gs, cs = sorted_roots(g.u.cpu().numpy()), sorted_roots(c.u.numpy())
        gap = (float(np.abs(gs - cs).max()) if gs.shape == cs.shape
               else float("inf"))
        # each path tracked alone equals its row of the last γ's batch
        # (Wilkinson-6's six 99-step tracks are left to the CPU tests)
        ends, ok = g.original
        gam = alg.replace(gamma_seed=alg.gamma_seed + 7919 * (
            g.counters["gamma_runs"] - 1))
        starts = ph._start_roots(degrees, c128, dev)
        fq = (lambda x: f(x, q))
        lone = name == "wilkinson6" or all(
            torch.equal(xi[0], ends[i]) and bool(oki[0]) == bool(ok[i])
            for i in range(starts.shape[0])
            for xi, oki, _ in [ph._track_paths(fq, degrees, gam, c128,
                                               starts=starts[i:i + 1])])
        stamped({"phase": "a33_poly", "case": name, "paths": int(np.prod(
            degrees)), "roots": len(g.u), "cpu_roots": len(c.u),
            "nsteps": g.stats.nsteps, "cpu_nsteps": c.stats.nsteps,
            "root_set_gap_to_cpu": gap, "counters": g.counters,
            "lone_tracks_bit_equal": (None if name == "wilkinson6"
                                      else lone), "card": card})
        check(f"(e) {name}: the CPU run's root set within 1e-10",
              len(g.u) == len(c.u) and gap <= 1e-10
              and int(g.retcode) == int(c.retcode) == 1)
        check(f"(e) {name}: every path alone bit-equal to its batch row",
              lone)
    f10 = quadratic_system(torch, POLY_N, POLY_SEED, dev)
    prob10 = nls.NonlinearProblem(f10, torch.zeros(POLY_N, dtype=f64,
                                                   device=dev))
    alg10 = ph.PolynomialHomotopy(degrees=(2,) * POLY_N)

    def poly10():
        return ph.solve_polynomial(prob10, alg10, gamma_retries=1)
    sol, wall, counts = run(poly10)
    ends, ok = sol.original
    resid = max(float(f10(r).abs().max()) for r in sol.u)
    # two paths alone: the same flags, the endpoints within 1e-12 (the
    # residual's einsum contracts otherwise at batch size 1)
    starts = ph._start_roots(alg10.degrees, c128, dev)
    lone = []
    for i in (0, 2 ** POLY_N - 1):
        xi, oki, _ = ph._track_paths(f10, alg10.degrees, alg10, c128,
                                     starts=starts[i:i + 1])
        lone.append({"flags_equal": bool(oki[0]) == bool(ok[i]),
                     "bit_equal": bool(torch.equal(xi[0], ends[i])),
                     "rel_gap": float((xi[0] - ends[i]).abs().max()
                                      / ends[i].abs().max())})
    # one warm run beside the reference while it still runs, to set
    # against the warm run after it (the host's load, in one call)
    beside = None
    if child.poll() is None:
        beside, = warm_walls(torch, poly10, count=1)
        beside = {"warm_wall_s": beside,
                  "reference_still_running": child.poll() is None}
    t_wait = time.perf_counter()
    out, _ = child.communicate(timeout=600)
    if child.returncode != 0:
        raise RuntimeError(f"--poly-reference exited {child.returncode}")
    ref = json.loads(out.strip().splitlines()[-1])
    timed.append(({"phase": "a33_poly", "case": f"quadratic{POLY_N}",
                   "paths": 2 ** POLY_N, "paths_ok": int(ok.sum()),
                   "distinct_roots": len(sol.u),
                   "path_steps": sol.stats.nsteps,
                   "loop_steps": sol.counters["loop_steps"],
                   "host_reads": counts["host_reads"],
                   "max_root_resid_inf": resid, "first_wall_s": wall,
                   "launches": counts["launches"], "lone_rows": lone,
                   "cpu_reference": ref,
                   "beside_reference": beside,
                   "waited_for_reference_s": time.perf_counter() - t_wait,
                   "card": card}, poly10, None))
    # the CPU reference has ended: the warm walls and profiles
    for line, fn, groups in timed:
        # the warm wall is the profiled run's (one run, for time)
        prof = profile_device(torch, fn, groups=groups, host_events=False)
        warm = prof["profiled_solve_s"]
        stamped({**line, "warm_wall_s": warm,
                 "device_idle_share": prof["device_idle_share"],
                 "device_busy_ms": prof["device_busy_ms"],
                 **({"device_ms_by_group": prof["device_ms_by_group"]}
                    if groups else {}),
                 "top_device_ms": prof["top_device_ms"][:6]})
    check("(e) quadratic system: the CPU run's count of distinct roots",
          len(sol.u) == ref["distinct_roots"])
    check("(e) quadratic system: roots' residuals under 1e-8",
          resid <= 1e-8)
    check("(e) quadratic system: lone tracks' flags, endpoints within "
          "1e-12", all(r["flags_equal"] and r["rel_gap"] <= 1e-12
                       for r in lone))
    f2 = lambda u, q: torch.stack([u[0] ** 2 + u[1] ** 2 - 4.0,  # noqa
                                   u[0] * u[1] - 1.0])
    roots, wall, counts = run(lambda: nls.solve_multistart(
        nls.NonlinearProblem(f2, torch.tensor([1.0, 1.0], dtype=f64,
                                              device=dev)), order=2))
    worst = max(float(f2(r, None).abs().max()) for r in roots)
    stamped({"phase": "a33_poly", "case": "multistart_system", "roots":
          len(roots), "max_resid_inf": worst, "wall_s": wall, **counts,
          "card": card})
    check("(e) solve_multistart: 4 roots, residuals under 1e-8",
          len(roots) == 4 and worst < 1e-8 and roots.is_cuda)
    hc = nls.NonlinearProblem(lambda u, q: torch.stack([
        u[0] ** 2 + u[1] ** 2 - 5.0, u[0] * u[1] - 2.0]),
        torch.tensor([1.0, 1.0], dtype=f64, device=dev))
    sol, wall, counts = run(lambda: nls.solve(hc, nls.HomotopyContinuationJL(
        all_roots=True, degrees=(2, 2))))
    found = {tuple(np.round(r).astype(int)) for r in sol.u.cpu().numpy()}
    stamped({"phase": "a33_poly", "case": "homotopy_continuation_jl",
          "retcode": sol.retcode.name,
          "roots": sorted([int(a), int(b)] for a, b in found),
          "max_resid": float(sol.resid.abs().max()), "wall_s": wall,
          **counts, "card": card})
    check("(e) HomotopyContinuationJL: the four roots (±1, ±2), (±2, ±1)",
          found == {(1, 2), (2, 1), (-1, -2), (-2, -1)}
          and float(sol.resid.abs().max()) <= 1e-7)

    # --- (f) C.3 and C.4 on the card ------------------------------------
    # at maxiters 100: the NaN row's Success codes come within 86 nf; the
    # MaxIters rows stop at 100 steps on both devices (the CPU tests hold
    # the default 1000 to the JAX package)
    names = ("Bisection", "Falsi", "Ridder", "Brent", "ITP", "Alefeld",
             "Muller", "ModAB")
    pvals = [0.3, float("nan"), 0.0, 1.0, 2.0]
    same = []
    for name in names:
        algc = getattr(nls, name)
        outs = {}
        for d in (dev, "cpu"):
            t = lambda x: torch.tensor(x, dtype=f64, device=d)  # noqa
            lone = nls.solve(nls.IntervalNonlinearProblem(
                lambda u, q: torch.log(u) - 0.5, (t(-1.0), t(3.0))), algc(),
                maxiters=100)
            batch = nls.solve(nls.IntervalNonlinearProblem(
                lambda u, q: u - q, (t([0.0] * 5), t([1.0] * 5)),
                t(pvals)), algc(), maxiters=100)
            outs[str(d)] = ([int(lone.retcode), lone.stats.nf,
                             float(lone.u)], batch.retcode.tolist(),
                            batch.stats.nf.tolist(), batch.u.tolist())
        g, c = outs[str(dev)], outs["cpu"]
        eq = (g[0][:2] == c[0][:2] and g[1:3] == c[1:3]
              and np.allclose(g[3], c[3], rtol=0, atol=1e-15,
                              equal_nan=True)
              and np.allclose(g[0][2], c[0][2], rtol=0, atol=1e-15,
                              equal_nan=True))
        same.append(eq)
        stamped({"phase": "a33_repairs", "case": "C.3", "method": name,
              "log_case": g[0], "nan_row_code": g[1][1], "codes": g[1],
              "nf": g[2], "equal_to_cpu": eq, "card": card})
        check(f"(f) C.3 {name}: the CPU run's codes, nf and u", eq)
        if name in ("Bisection", "Falsi", "Brent", "ModAB"):
            check(f"(f) C.3 {name}: Success on the NaN row", g[1][1] == 1)
    q = torch.tensor([-1.0, 2.0], dtype=f64, device=dev).requires_grad_(True)
    sol = nls.solve(nls.NonlinearProblem(
        lambda u, r: u * u - r, torch.tensor([1.0, 1.5], dtype=f64,
                                             device=dev), q),
        nls.NewtonRaphson(), maxiters=30)
    grad, = torch.autograd.grad(sol.u.sum(), q)
    stamped({"phase": "a33_repairs", "case": "C.4", "retcode":
          sol.retcode.name, "grad": grad.tolist(), "card": card})
    check("(f) C.4: MaxIters, a NaN gradient and no exception",
          sol.retcode == nls.ReturnCode.MaxIters
          and bool(torch.isnan(grad).all()))


def slice17_phase(torch, nls, _backend, brusselator, stencil,
                  fft_poisson_preconditioner, card, flag_sol, flag_pm, u64,
                  ssol_ref):
    """Phase 26: complex states under the engines that order values,
    sparsity detection at the flagship's width and double-f32 refinement
    on the card (see the module docstring).  ``flag_sol`` is phase 4's f32
    root, ``flag_pm`` its preconditioner, ``u64`` phase 5's f64 polish and
    ``ssol_ref`` phase 6's sparse solve on the analytic pattern.  Each run
    with the launch counters at 0 just before and read just after.  Returns
    the launches of (b)'s detected-pattern solve and (c)'s refinement, for
    the kernels line."""
    import numpy as np
    from nonlinearsolve_tpu_torch.core import solve as solve_mod
    from nonlinearsolve_tpu_torch.models import bratu
    from nonlinearsolve_tpu_torch.ops import doublef32 as dfm
    from nonlinearsolve_tpu_torch.ops.coloring import detect_sparsity
    t_phase = time.perf_counter()
    f32, f64, c128 = torch.float32, torch.float64, torch.complex128
    dev = torch.device("cuda")
    failed = []

    def check(name, ok):
        if not ok:
            failed.append(name)

    def run(fn):
        torch.cuda.synchronize()
        _backend.reset_counters()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, {
            k: v for k, v in _backend.LAUNCHES.items() if v}

    def stats_of(sol):
        s = sol.stats
        return [int(s.nf), int(s.njacs), int(s.nfactors), int(s.nsolve),
                int(s.nsteps)]

    # --- (a) complex states under the engines that order values ---------
    jf = nls.NonlinearFunction(f=lambda u, p: u * u * u - p,
                               jac=lambda u, p: torch.diag(3 * u * u))
    cubic = nls.NonlinearProblem(jf, torch.tensor([-0.8 + 1.5j], dtype=c128,
                                                  device=dev), 8.0)
    for name in ("LevenbergMarquardt", "TrustRegion", "AndersonAcceleration",
                 "SimpleTrustRegion", "SimpleDFSane"):
        sol, wall, launched = run(lambda: nls.solve(
            cubic, getattr(nls, name)()))
        code, stats = JAX_ORDERED[name]
        ok = (int(sol.retcode) == code and stats_of(sol) == stats
              and sol.u.device.type == "cuda" and not launched)
        check(f"(a) cubic {name}", ok)
        emit({"phase": "slice17_complex_order", "case": "cubic",
              "alg": name, "retcode": sol.retcode.name,
              "stats": stats_of(sol), "jax": [code, stats],
              "u": [complex(sol.u[0]).real, complex(sol.u[0]).imag],
              "wall_s": wall, "launches": launched, "ok": ok})
    for name in ("RobustMultiNewton", "PseudoTransient"):
        try:
            nls.solve(cubic, getattr(nls, name)())
            refused = False
        except NotImplementedError as e:
            refused = "fails to trace" in str(e)
        check(f"(a) {name} refused", refused)
        emit({"phase": "slice17_complex_order", "case": "cubic",
              "alg": name, "refused": refused,
              "jax": "fails to trace (tools/complex_reference.py)"})
    N = 32
    u0 = brusselator.init_u0(N, f64)
    z = torch.as_tensor(np.random.default_rng(0).standard_normal(
        tuple(u0.shape)), device=dev)
    p = brusselator.default_p(N, f64)
    real, _w, _l = run(lambda: nls.solve(nls.NonlinearProblem(
        brusselator.brusselator_2d, u0, p), nls.TrustRegion(), abstol=1e-10))
    cplx, wall, launched = run(lambda: nls.solve(nls.NonlinearProblem(
        brusselator.brusselator_2d, (u0 + 1e-3j * z).to(c128), p),
        nls.TrustRegion(), abstol=1e-10))
    code, stats = JAX_ORDERED["complex_brusselator32_tr"]
    re_gap = float((cplx.u.real - real.u).abs().max())
    im_max = float(cplx.u.imag.abs().max())
    ok = (int(cplx.retcode) == code and stats_of(cplx) == stats
          and stats_of(real) == stats and re_gap < 1e-10 and im_max < 1e-10
          and not launched)
    check("(a) complex Brusselator 32 under TrustRegion", ok)
    emit({"phase": "slice17_complex_order", "case": "complex_brusselator",
          "N": N, "unknowns": 2 * N * N, "alg": "TrustRegion",
          "retcode": cplx.retcode.name, "stats": stats_of(cplx),
          "real_stats": stats_of(real), "jax": [code, stats],
          "max_real_gap": re_gap, "max_imag": im_max, "wall_s": wall,
          "ok": ok, "card": card})
    del real, cplx

    # --- (b) sparsity detection at the flagship's width -----------------
    N = 512
    n = 2 * N * N
    pat = brusselator.sparsity_pattern(N)
    plain = flat_problem(nls, brusselator, N, f64, dev)
    t0 = time.perf_counter()
    got = detect_sparsity(lambda u: plain.f.f(u, plain.p), n,
                          dtype=f64, device=dev)
    plain_s = time.perf_counter() - t0
    ok_plain = (np.array_equal(got.indptr, pat.indptr)
                and np.array_equal(got.indices, pat.indices))
    perm = np.random.default_rng(42).permutation(n)
    pinv = np.argsort(perm)
    permuted = flat_problem(nls, brusselator, N, f64, dev, perm=perm)
    t0 = time.perf_counter()
    gotp = detect_sparsity(lambda w: permuted.f.f(w, permuted.p), n,
                           dtype=f64, device=dev)
    perm_s = time.perf_counter() - t0
    want = type(pat).from_pattern(pinv[pat.row_ids], pinv[pat.indices],
                                  (n, n))
    ok_perm = (np.array_equal(gotp.indptr, want.indptr)
               and np.array_equal(gotp.indices, want.indices))
    check("(b) detected pattern == sparsity_pattern(512)", ok_plain)
    check("(b) permuted pattern == (pinv[rows], pinv[cols])", ok_perm)
    emit({"phase": "slice17_detection", "N": N, "unknowns": n,
          "nnz": got.nnz, "plain_equal": ok_plain, "plain_host_s": plain_s,
          "permuted_nnz": gotp.nnz, "permuted_equal": ok_perm,
          "permuted_host_s": perm_s,
          "note": "host seconds: the ATen trace on the card plus the "
                  "scipy propagation"})
    del got, gotp, want, permuted
    salg = sparse_alg(nls, fft_poisson_preconditioner, N)
    if ssol_ref is None:              # --only 26: phase 6's solve rebuilt
        ssol_ref = nls.solve(plain, salg, abstol=1e-4, maxiters=30)
    dprob = flat_problem(nls, brusselator, N, f64, dev, with_pattern=False)
    dsol, wall, det_launches = run(lambda: nls.solve(
        dprob, salg, abstol=1e-4, maxiters=30))
    dplan, = solve_mod._SPARSE_PLANS[dprob.f].values()
    bit_equal = (dsol.retcode == ssol_ref.retcode
                 and vars(dsol.stats) == vars(ssol_ref.stats)
                 and bool(torch.equal(dsol.u, ssol_ref.u)))
    ok = (dsol.retcode == nls.ReturnCode.Success and bit_equal
          and np.array_equal(dplan.pattern.indices, pat.indices)
          and det_launches.get("dia_spmv", 0) == dsol.counters["jvp"] > 0
          and det_launches.get("gather_select", 0) == dsol.stats.njacs)
    check("(b) detected-pattern solve bit-equal to the analytic one", ok)
    emit({"phase": "slice17_detected_sparse_path", "N": N,
          "retcode": dsol.retcode.name, "stats": vars(dsol.stats),
          "bit_equal_to_analytic_pattern": bit_equal,
          "jac_products": dsol.counters["jvp"], "launches": det_launches,
          "first_solve_s_with_detection_and_plan": wall, "ok": ok,
          "card": card})
    del dsol, dprob, dplan, plain

    # --- (c) double-f32 refinement of the flagship's f32 root -----------
    rng = np.random.default_rng(17)
    a = torch.as_tensor(rng.standard_normal(1 << 22) * 1e4,
                        dtype=f32, device=dev)
    b = torch.as_tensor(rng.standard_normal(1 << 22), dtype=f32, device=dev)
    s_, e_ = dfm.two_sum(a, b)
    p_, pe_ = dfm.two_prod(a, b)
    sum_exact = bool(torch.equal(s_.double() + e_.double(),
                                 a.double() + b.double()))
    prod_exact = bool(torch.equal(p_.double() + pe_.double(),
                                  a.double() * b.double()))
    self_ok = dfm.self_check(dev)
    check("(c) two_sum / two_prod error-free on the card",
          sum_exact and prod_exact and self_ok)
    emit({"phase": "slice17_error_free", "pairs": 1 << 22,
          "two_sum_exact": sum_exact, "two_prod_exact": prod_exact,
          "self_check": self_ok})
    del a, b, s_, e_, p_, pe_
    p64 = brusselator.default_p(N, f64)
    p32 = brusselator.default_p(N, f32)

    def refine():
        return nls.refine_root(
            flag_sol.u,
            lambda uh, ul: brusselator.brusselator_2d_df32(uh, ul, p64),
            lambda uh: (lambda v: stencil.brusselator_jvp(uh, v, p32)),
            precond_fn=flag_pm, **REFINE)

    res, first_wall, ref_launches = run(refine)
    _res2, warm_wall, _l2 = run(refine)
    u_ref = res.u.hi.double() + res.u.lo.double()
    scale = float(u64.abs().max())
    refined = float((u_ref - u64).abs().max()) / scale
    fast = float((flag_sol.u.double() - u64).abs().max()) / scale
    ok = (refined <= 1e-8 and refined < fast
          and ref_launches.get("brusselator_jvp", 0) > 0)
    check("(c) refined flagship root within 1e-8 of the f64 polish", ok)
    emit({"phase": "slice17_refinement", "N": N, **REFINE,
          "defect_inf": float(res.defect_norm), "refined_rel_inf": refined,
          "fast_rel_inf": fast, "limit": 1e-8, "first_wall_s": first_wall,
          "warm_wall_s": warm_wall, "launches": ref_launches, "ok": ok,
          "card": card})
    del res, _res2, u_ref

    # --- (d) auto_refine through the graph front end: Bratu 128² --------
    B = BRATU_REFINE
    sparse = nls.NewtonRaphson(autodiff=nls.JacobianPolicy(mode="sparse"))
    prob32 = bratu.make_problem(B["N"], dtype=f32)
    sol32 = nls.solve(prob32, sparse, abstol=B["abstol32"], maxiters=50)
    sol64 = nls.solve(bratu.make_problem(B["N"], dtype=f64), sparse,
                      abstol=1e-10, maxiters=100)
    res, wall, auto_launches = run(lambda: nls.auto_refine(
        prob32, sol32.u, rounds=B["rounds"], restart=B["restart"],
        krylov_maxiter=B["krylov_maxiter"]))
    u_ref = res.u.hi.double() + res.u.lo.double()
    scale = float(sol64.u.abs().max())
    refined = float((u_ref - sol64.u).abs().max()) / scale
    fast = float((sol32.u.double() - sol64.u).abs().max()) / scale
    ok = (sol32.retcode == nls.ReturnCode.Success
          and sol64.retcode == nls.ReturnCode.Success
          and refined <= 1e-9 and refined <= fast / 10.0)
    check("(d) auto_refine Bratu 128² within 1e-9 and 10x the f32 root", ok)
    emit({"phase": "slice17_auto_refine", **B,
          "f32_retcode": sol32.retcode.name, "f32_stats": stats_of(sol32),
          "f64_stats": stats_of(sol64), "defect_inf": float(res.defect_norm),
          "refined_rel_inf": refined, "fast_rel_inf": fast, "limit": 1e-9,
          "wall_s": wall, "launches": auto_launches, "ok": ok, "card": card})
    emit({"phase": "slice17_timing", "phase_seconds":
          time.perf_counter() - t_phase, "card": card})
    if failed:
        raise AssertionError(f"phase 26 failed: {failed}")
    return {"detected_sparse_path": det_launches,
            "refinement": ref_launches}


MULTIHOST_N = 128       # the multihost problem's grid (see slice18_phase)
CONFIG5_N = 128         # __graft_entry__.py's config-5 grid


def _mg_phase(torch, nls, _backend, dev, card):
    """Phase 27 (a): multigrid at 1024² (the Dirichlet Newton problem) and
    the variable-coefficient GMRES counts at 256²."""
    import numpy as np
    from nonlinearsolve_tpu_torch.ops.krylov import gmres
    from nonlinearsolve_tpu_torch.ops.multigrid import (
        _lap, multigrid_preconditioner)
    f64 = torch.float64
    failed = []
    N = 1024
    h = 1.0 / N
    g = torch.as_tensor(np.random.default_rng(1).standard_normal((N, N)),
                        device=dev)

    def f(u, p):
        return (1.0 / h ** 2) * _lap(u, "dirichlet") - u ** 3 - u + p

    M = multigrid_preconditioner((N, N), 1.0, h, c=1.0, bc="dirichlet")
    alg = nls.NewtonRaphson(linsolve=nls.LinearSolver(
        method="gmres", restart=20, precond_fn=lambda u: M))
    abstol = 1e-9 * (N / 32) ** 2
    prob = nls.NonlinearProblem(f, torch.zeros(N, N, dtype=f64, device=dev),
                                g)
    torch.cuda.synchronize()
    _backend.reset_counters()
    t0 = time.perf_counter()
    sol = nls.solve(prob, alg, abstol=abstol)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    resid = float(sol.resid.abs().max())
    launches = {k: v for k, v in _backend.LAUNCHES.items() if v}
    v = torch.as_tensor(np.random.default_rng(2).standard_normal((N, N)),
                        device=dev)
    apply_ms = event_time_ms(torch, lambda: M(v), calls=10)
    rec = {"phase": "slice18_multigrid", "N": N, "dtype": "float64",
           "retcode": sol.retcode.name, "stats": vars(sol.stats),
           "resid_inf": resid, "abstol": abstol,
           "krylov_iters": sol.counters["krylov_iters"],
           "host_syncs": sol.counters["host_syncs"], "first_solve_s": wall,
           "custom_kernel_launches": launches,
           "vcycle_apply_ms": apply_ms, "card": card}
    if sol.retcode != nls.ReturnCode.Success or resid > abstol or launches:
        failed.append("(a) Newton with multigrid at 1024²")
    # the variable-coefficient operator at 256²: GMRES(30) iterations
    Nv = 256
    hv = 1.0 / Nv
    rng = np.random.default_rng(0)
    cfield = torch.as_tensor(1.0 + 2.0 * rng.random((Nv, Nv)), device=dev)
    b = torch.as_tensor(rng.standard_normal((Nv, Nv)), device=dev)

    def A(u):
        return (1.0 / hv ** 2) * _lap(u, "dirichlet") - cfield * u

    iters = {}
    for name, M2, maxiter in (
            ("none", None, 3000),
            ("jacobi_mg", multigrid_preconditioner(
                (Nv, Nv), 1.0, hv, c=cfield, bc="dirichlet"), 500),
            ("chebyshev_mg", multigrid_preconditioner(
                (Nv, Nv), 1.0, hv, c=cfield, bc="dirichlet",
                smoother="chebyshev", nu=3), 500)):
        t0 = time.perf_counter()
        r = gmres(A, b, restart=30, rtol=1e-8, maxiter=maxiter, M=M2)
        torch.cuda.synchronize()
        iters[name] = {"iterations": r.iterations, "success": r.success,
                       "seconds": time.perf_counter() - t0}
    rec["gmres_256_variable_coefficient"] = iters
    emit(rec)
    if not (iters["jacobi_mg"]["success"] and iters["chebyshev_mg"]["success"]
            and iters["chebyshev_mg"]["iterations"]
            <= iters["jacobi_mg"]["iterations"]
            and iters["jacobi_mg"]["iterations"]
            < iters["none"]["iterations"] // 5):
        failed.append("(a) GMRES counts at 256²")
    return failed


def _spectral_phase(torch, nls, _backend, brusselator,
                    fft_poisson_preconditioner, u64, card):
    """Phase 27 (b): the matrix-product DFT and the hybrid on the
    flagship."""
    import numpy as np
    from nonlinearsolve_tpu_torch.ops.preconditioners import (
        hybrid_poisson_preconditioner, mxu_poisson_preconditioner)
    N = 512
    dev = torch.device("cuda")
    prob, _alg, pm = flagship_setup(torch, nls, brusselator,
                                    fft_poisson_preconditioner, N)
    kw = dict(shift=3.0, n_components=2)
    v = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (N, N, 2)).astype(np.float32), device=dev)
    exact = pm(v)
    errors = {"fft_apply_ms": event_time_ms(torch, lambda: pm(v), calls=20)}
    for name in (None, "default", "bf16", "high", "highest", "f32"):
        apply = mxu_poisson_preconditioner((N, N), 10.0, 1.0 / (N - 1),
                                           precision=name, **kw)(prob.u0)
        got = apply(v)
        errors[str(name)] = {
            "rel_err": float((got - exact).abs().max()
                             / exact.abs().max()),
            "apply_ms": event_time_ms(torch, lambda: apply(v), calls=20)}
    failed = []
    if torch.get_float32_matmul_precision() != "highest":
        failed.append("(b) the f32 matmul precision left changed")
    f0 = float(prob.f.f(prob.u0, prob.p).abs().max())
    switch = 0.1 * f0
    hyb = hybrid_poisson_preconditioner((N, N), 10.0, 1.0 / (N - 1),
                                        switch_abs=switch, **kw)
    branches = {"loose": 0, "exact": 0}

    def counting(u, fu):
        branches["loose" if float(fu.abs().max()) > switch
                 else "exact"] += 1
        return hyb(u, fu)

    counting.wants_residual = True
    runs = {}
    for label, precond in (
            ("mxu_highest", mxu_poisson_preconditioner(
                (N, N), 10.0, 1.0 / (N - 1), precision="highest", **kw)),
            ("hybrid", counting)):
        alg = nls.NewtonRaphson(
            linsolve=nls.LinearSolver(method="gmres", restart=8,
                                      krylov_maxiter=100,
                                      precond_fn=precond),
            forcing=nls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))
        torch.cuda.synchronize()
        _backend.reset_counters()
        t0 = time.perf_counter()
        sol = nls.solve(prob, alg, abstol=5.0, maxiters=30)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dist = float((sol.u.double() - u64).abs().max()
                     / u64.abs().max())
        runs[label] = {"retcode": sol.retcode.name, "stats": vars(sol.stats),
                       "resid_inf": float(sol.resid.abs().max()),
                       "jac_products": sol.counters["jvp"],
                       "k1_launches": _backend.LAUNCHES["brusselator_jvp"],
                       "root_rel_inf_to_f64_polish": dist,
                       "first_solve_s": wall}
        if _backend.LAUNCHES["brusselator_jvp"] != sol.counters["jvp"]:
            failed.append(f"(b) {label}: K1 launches != Jacobian products")
    runs["hybrid"]["linearizations"] = dict(branches)
    runs["hybrid"]["switch_abs"] = switch
    emit({"phase": "slice18_spectral", "N": N, "dtype": "float32",
          "mxu_rel_err_to_fft": errors, "solves": runs,
          "f0_inf": f0, "card": card,
          "note": "a stall of the loose paths is recorded, not required"})
    return failed


def _sharded_csr_phase(torch, nls, _backend, spmv, mesh, csr7, card):
    """Phase 27 (c): the row-sharded CSR matvec (K5 on each shard) on the
    one-rank mesh."""
    import numpy as np
    import scipy.sparse as sp
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from nonlinearsolve_tpu_torch.ops.krylov import gmres
    from nonlinearsolve_tpu_torch.ops.multigrid import (
        multigrid_preconditioner)
    from nonlinearsolve_tpu_torch.ops.sparse import CSR
    from nonlinearsolve_tpu_torch.ops.sparse_jac import plan_sparse_jacobian
    from nonlinearsolve_tpu_torch.parallel import make_sharded_csr_matvec
    from nonlinearsolve_tpu_torch.parallel.scaling import (
        weak_scaling_sparse_report)
    dev, f64 = torch.device("cuda"), torch.float64
    failed = []
    launches = {}

    def sharded(x):
        return distribute_tensor(x, mesh, [Shard(0)], src_data_rank=None)

    # the CSR route's permuted 512² Jacobian at its root (phase 7)
    n = csr7.shape[0]
    mv = make_sharded_csr_matvec(csr7, mesh)
    plan = mv.plan
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(n),
                        device=dev)
    torch.cuda.synchronize()
    _backend.reset_counters()
    y = mv(x)
    torch.cuda.synchronize()
    launches["sharded_product"] = dict(_backend.LAUNCHES)
    nnz = int(plan.shard_indptr[0, -1])
    s_indptr = torch.as_tensor(plan.shard_indptr[0].astype(np.int32),
                               device=dev)
    s_cols = torch.as_tensor(plan.seg_pos[0, :nnz], device=dev)
    s_data = csr7.data[int(plan.seg_src[0, 0]):][:nnz].contiguous()
    indptr, indices = csr7.device_tables(dev)
    whole = spmv.gather_spmv(indptr, indices, csr7.data, x)
    on_shard = spmv.gather_spmv(s_indptr, s_cols, s_data, x)
    yl = y.to_local()
    k5 = k5_case(torch, spmv, "sharded_csr_route_512_permuted", "float64",
                 s_indptr, s_cols, s_data, x, [n, n])
    rec = {"phase": "slice18_sharded_csr", "n": n, "nnz": nnz,
           "mode": plan.mode, "tier": mv.tier, "chunk": plan.chunk,
           "pallas_ok": plan.pallas_ok,
           "launches": launches["sharded_product"],
           "dtensor": isinstance(y, DTensor),
           "bit_equal_k5_on_shard_tables": bool(torch.equal(yl, on_shard)),
           "bit_equal_unsharded_k5": bool(torch.equal(yl, whole)),
           "sharded_call_ms_events": event_time_ms(torch, lambda: mv(x)),
           "local_product_ms_events": event_time_ms(
               torch, lambda: mv.local(x)),
           "k5_on_shard_tables": {k: k5[k] for k in (
               "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
               "share_of_bound", "max_abs_err")},
           "card": card}
    emit(rec)
    if not (mv.tier == "pallas" and rec["dtensor"]
            and launches["sharded_product"]["gather_spmv"] == 1
            and rec["bit_equal_k5_on_shard_tables"]
            and rec["bit_equal_unsharded_k5"]):
        failed.append("(c) the sharded product")

    # the JAX multihost problem A u + 0.1u³ − b through the sharded matvec
    Ng = MULTIHOST_N
    rng = np.random.default_rng(0)
    nm = Ng * Ng
    d = np.ones(nm)
    A = sp.diags([d * 4, -d[:-1], -d[:-1], -d[:-Ng], -d[:-Ng]],
                 [0, 1, -1, Ng, -Ng], format="csr")
    A.data = A.data * (1 + 0.1 * rng.standard_normal(A.nnz))
    b = torch.as_tensor(rng.standard_normal(nm), device=dev)
    csrA = CSR(torch.as_tensor(A.data, device=dev),
               np.asarray(A.indices, np.int32),
               np.asarray(A.indptr, np.int32), (nm, nm))
    mvA = make_sharded_csr_matvec(csrA, mesh)
    bs = sharded(b)
    alg = nls.NewtonRaphson(linsolve=nls.LinearSolver(
        method="gmres", restart=30, krylov_maxiter=400))
    sols = {}
    for label, f, jvp, u0 in (
            ("sharded", lambda u, p: mvA(u) + 0.1 * u ** 3 - bs,
             lambda v, u, p: mvA(v) + 0.3 * u ** 2 * v,
             sharded(torch.zeros(nm, dtype=f64, device=dev))),
            ("csr_matvec", lambda u, p: csrA.matvec(u) + 0.1 * u ** 3 - b,
             lambda v, u, p: csrA.matvec(v) + 0.3 * u ** 2 * v,
             torch.zeros(nm, dtype=f64, device=dev))):
        torch.cuda.synchronize()
        _backend.reset_counters()
        t0 = time.perf_counter()
        sol = nls.solve(nls.NonlinearProblem(
            nls.NonlinearFunction(f=f, jvp=jvp), u0), alg, abstol=1e-5,
            maxiters=50)
        torch.cuda.synchronize()
        sols[label] = (sol, time.perf_counter() - t0,
                       dict(_backend.LAUNCHES))
    (sd, sd_s, sd_l), (sc, sc_s, sc_l) = sols["sharded"], sols["csr_matvec"]
    ud = sd.u.full_tensor()
    du = float((ud - sc.u).abs().max())
    launches["multihost_newton"] = sd_l
    rec = {"phase": "slice18_multihost_newton", "grid": Ng, "rows": nm,
           "mode": mvA.plan.mode, "tier": mvA.tier,
           "sharded": {"retcode": sd.retcode.name, "stats": vars(sd.stats),
                       "krylov_iters": sd.counters["krylov_iters"],
                       "jac_products": sd.counters["jvp"],
                       "k5_launches": sd_l["gather_spmv"],
                       "resid_inf": float(sd.resid.full_tensor().abs().max()),
                       "first_solve_s": sd_s},
           "csr_matvec": {"retcode": sc.retcode.name,
                          "stats": vars(sc.stats),
                          "krylov_iters": sc.counters["krylov_iters"],
                          "launches": {k: v for k, v in sc_l.items() if v},
                          "first_solve_s": sc_s},
           "root_inf_distance": du, "limit": 1e-6, "card": card}
    emit(rec)
    if not (sd.retcode == nls.ReturnCode.Success and du <= 1e-6
            and sd_l["gather_spmv"] >= sd.counters["jvp"] > 0):
        failed.append("(c) the multihost Newton problem")

    # the config-5 shape at the JAX package's 128²
    N5 = CONFIG5_N
    m5, n5 = N5 * N5, 2 * N5 * N5
    Ac, Bc, a5 = 1.0, 3.0, 50.0
    d5 = np.ones(m5)
    L5 = sp.diags([4 * d5, -d5[:-1], -d5[:-1], -d5[:-N5], -d5[:-N5]],
                  [0, 1, -1, N5, -N5], format="csr")
    I5 = sp.identity(m5, format="csr")
    rows5, cols5 = [], []
    for (rr, cc, M5) in ((0, 0, L5), (0, 1, I5), (1, 0, I5), (1, 1, L5)):
        Mc = M5.tocoo()
        rows5.append(2 * Mc.row + rr)
        cols5.append(2 * Mc.col + cc)
    patt = sp.csr_matrix((np.ones(sum(r.size for r in rows5)),
                          (np.concatenate(rows5), np.concatenate(cols5))),
                         shape=(n5, n5))
    patt.sort_indices()
    csr5 = CSR(torch.zeros(patt.nnz, dtype=f64, device=dev),
               np.asarray(patt.indices, np.int32),
               np.asarray(patt.indptr, np.int32), (n5, n5))

    def f5(u):
        U = u.reshape(N5, N5, 2)
        Up = F.pad(U, (0, 0, 1, 1, 1, 1))
        lap = (Up[:-2, 1:-1] + Up[2:, 1:-1] + Up[1:-1, :-2]
               + Up[1:-1, 2:] - 4.0 * U)
        u0c, v0c = U[..., 0], U[..., 1]
        fu = a5 * lap[..., 0] + Ac + u0c * u0c * v0c - (Bc + 1.0) * u0c
        fv = a5 * lap[..., 1] + Bc * u0c - u0c * u0c * v0c
        return torch.stack([fu, fv], dim=-1).reshape(-1)

    jac5 = plan_sparse_jacobian(f5, n5, n5, sparsity=csr5, device=dev)
    mv5 = make_sharded_csr_matvec(csr5, mesh, use_pallas=True)
    mg5 = multigrid_preconditioner((N5, N5), a5, 1.0, c=0.0,
                                   bc="dirichlet")

    def pm5(v):
        w = v.reshape(N5, N5, 2)
        return torch.stack([mg5(w[..., 0]), mg5(w[..., 1])],
                           dim=-1).reshape(v.shape)

    from torch.distributed.tensor.experimental import implicit_replication
    U0 = torch.stack([torch.full((N5, N5), Ac, dtype=f64, device=dev),
                      torch.full((N5, N5), Bc / Ac, dtype=f64, device=dev)],
                     dim=-1).reshape(-1)
    torch.cuda.synchronize()
    _backend.reset_counters()
    t0 = time.perf_counter()
    u5, steps, kry = U0, 0, 0
    for _ in range(20):
        J = jac5(f5, u5)
        r = f5(u5)
        with implicit_replication():
            res = gmres(lambda v: mv5(v, data=J.data), -sharded(r), M=pm5,
                        rtol=1e-6, restart=40, maxiter=400)
        u5 = u5 + res.x.full_tensor()
        steps += 1
        kry += res.iterations
        if float(r.abs().max()) <= 1e-8:
            break
    torch.cuda.synchronize()
    c5_s = time.perf_counter() - t0
    launches["config5"] = dict(_backend.LAUNCHES)
    resid5 = float(f5(u5).abs().max())
    ref5 = nls.solve(nls.NonlinearProblem(
        nls.NonlinearFunction(f=lambda u, p: f5(u), jac_prototype=csr5), U0),
        nls.NewtonRaphson(linsolve=nls.LinearSolver(
            method="gmres", restart=40, krylov_maxiter=400,
            precond_fn=pm5)), abstol=1e-8, maxiters=20)
    du5 = float((u5 - ref5.u).abs().max())
    rec = {"phase": "slice18_config5", "grid": N5, "unknowns": n5,
           "nnz": patt.nnz, "n_colors": jac5.n_colors,
           "mode": mv5.plan.mode, "tier": mv5.tier, "hl": mv5.plan.hl,
           "hr": mv5.plan.hr, "chunk": mv5.plan.chunk, "newton_steps": steps,
           "krylov_iters": kry, "resid_inf": resid5,
           "k5_launches": launches["config5"]["gather_spmv"],
           "launches": {k: v for k, v in launches["config5"].items() if v},
           "seconds": c5_s, "reference_retcode": ref5.retcode.name,
           "reference_stats": vars(ref5.stats),
           "root_inf_distance_to_reference": du5, "limit": 1e-6,
           "card": card}
    emit(rec)
    if not (resid5 <= 1e-8 and du5 <= 1e-6 and mv5.tier == "pallas"
            and launches["config5"]["gather_spmv"] >= kry > 0):
        failed.append("(c) the config-5 shape")

    # the sparse weak-scaling report at 4M rows a device
    torch.cuda.synchronize()
    _backend.reset_counters()
    t0 = time.perf_counter()
    rows = weak_scaling_sparse_report([1], rows_per_device=1 << 22)
    torch.cuda.synchronize()
    launches["weak_scaling_sparse"] = dict(_backend.LAUNCHES)
    emit({"phase": "slice18_weak_scaling_sparse",
          "rows_per_device": 1 << 22, "n_matvecs": 50, "rows": rows,
          "k5_launches": launches["weak_scaling_sparse"]["gather_spmv"],
          "seconds": time.perf_counter() - t0, "card": card})
    if not (len(rows) == 1 and rows[0][2] == 1.0 and rows[0][1] > 0
            and launches["weak_scaling_sparse"]["gather_spmv"] == 100):
        failed.append("(c) the sparse weak-scaling report")
    return failed, launches, rec_k5(k5, plan, launches)


def rec_k5(k5, plan, launches):
    """K5's record on the sharded matvec, for the kernels line."""
    return {"tables": "sharded_csr_route_512_permuted (one shard)",
            "launches_in": {k: v["gather_spmv"] for k, v in launches.items()},
            "mode": plan.mode, "chunk": plan.chunk,
            **{k: k5[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "share_of_bound",
                                  "max_abs_err")}}


def slice18_setup(torch, nls, brusselator, fft_poisson_preconditioner):
    """For ``--only 27``: phase 7's permuted Jacobian at its root (the CSR
    route's solve, f64 N=512) and phase 10's 3D root and nsteps (256³
    f32, K9), solved as those phases solve them."""
    import numpy as np
    from nonlinearsolve_tpu_torch.core import solve as solve_mod
    from nonlinearsolve_tpu_torch.models import reaction_diffusion
    dev, N, N3 = torch.device("cuda"), 512, 256
    perm = np.random.default_rng(42).permutation(N * N * 2)
    cprob = flat_problem(nls, brusselator, N, torch.float64, dev, perm=perm)
    calg = sparse_alg(nls, fft_poisson_preconditioner, N, perm=perm,
                      dev=dev)
    csol = nls.solve(cprob, calg, abstol=1e-4, maxiters=30)
    cplan, = solve_mod._SPARSE_PLANS[cprob.f].values()
    jac = cplan(lambda u: cprob.f.f(u, cprob.p), csol.u)
    prob3 = reaction_diffusion.make_problem(N3, dtype=torch.float32,
                                            kernel_jvp=True)
    pm3 = fft_poisson_preconditioner((N3, N3, N3), 0.01, 1.0 / N3,
                                     shift=-0.9)
    alg3 = nls.NewtonRaphson(
        linsolve=nls.LinearSolver(method="gmres", restart=8,
                                  krylov_maxiter=200, precond_fn=pm3),
        forcing=nls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))
    sol3 = nls.solve(prob3, alg3, abstol=1e-5 * N3, maxiters=30)
    return jac, (sol3.u, sol3.stats.nsteps)


def slice18_phase(torch, nls, _backend, brusselator, spmv,
                  fft_poisson_preconditioner, card, u64, csr7, rd3d):
    """Phase 27 (see the module docstring).  ``u64``: phase 5's f64
    polish; ``csr7``: phase 7's permuted Jacobian at its root (a CSR);
    ``rd3d``: phase 10's (root, nsteps).  Returns K5's record on the
    sharded matvec."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from nonlinearsolve_tpu_torch.models import problems23 as p23
    from nonlinearsolve_tpu_torch.models import reaction_diffusion
    from nonlinearsolve_tpu_torch.parallel import (create_mesh,
                                                   distributed_solve)
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    failed = _mg_phase(torch, nls, _backend, dev, card)
    failed += _spectral_phase(torch, nls, _backend, brusselator,
                              fft_poisson_preconditioner, u64, card)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = create_mesh()
        f_c, launches, k5_rec = _sharded_csr_phase(torch, nls, _backend,
                                                   spmv, mesh, csr7, card)
        failed += f_c

        # (d) distributed_solve: BASELINE config 5's one-card half
        N3 = 256
        root3, nsteps3 = rd3d
        prob = reaction_diffusion.make_problem(N3, dtype=torch.float32)
        pm3 = fft_poisson_preconditioner((N3, N3, N3), 0.01, 1.0 / N3,
                                         shift=-0.9)
        alg3 = nls.NewtonRaphson(
            linsolve=nls.LinearSolver(method="gmres", restart=8,
                                      krylov_maxiter=200, precond_fn=pm3),
            forcing=nls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))
        abstol3 = 1e-5 * N3
        torch.cuda.synchronize()
        _backend.reset_counters()
        t0 = time.perf_counter()
        sol = distributed_solve(prob, alg3, mesh, abstol=abstol3,
                                maxiters=30)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d_launches = {k: v for k, v in _backend.LAUNCHES.items() if v}
        u = sol.u.full_tensor()
        dist3 = float((u - root3).abs().max() / root3.abs().max())

        def warm():
            distributed_solve(prob, alg3, mesh, abstol=abstol3, maxiters=30)

        prof = profile_device(torch, warm, host_events=False)
        rec = {"phase": "slice18_distributed_solve", "N": N3,
               "dtype": "float32", "retcode": sol.retcode.name,
               "stats": vars(sol.stats), "nsteps_phase10": nsteps3,
               "resid_inf": float(sol.resid.full_tensor().abs().max()),
               "root_rel_inf_to_phase10": dist3, "limit": 1e-4,
               "dtensor": isinstance(sol.u, DTensor),
               "placements": [str(p) for p in sol.u.placements]
               if isinstance(sol.u, DTensor) else None,
               "krylov_iters": sol.counters["krylov_iters"],
               "jac_products": sol.counters["jvp"],
               "host_syncs": sol.counters["host_syncs"],
               "first_solve_s": wall, "launches": d_launches, **prof,
               "card": card}
        emit(rec)
        if not (sol.retcode == nls.ReturnCode.Success
                and abs(sol.stats.nsteps - nsteps3) <= 1 and dist3 <= 1e-4
                and rec["dtensor"] and list(sol.u.placements) == [Shard(0)]):
            failed.append("(d) distributed_solve")
        del sol, u, prob

        # (e) solve_ensemble(mesh=): phase 22's problem-9 batch
        B = 262144
        tp9 = p23.PROBLEMS_23[8]
        xi = np.random.default_rng(9).uniform(-1.0, 1.0,
                                              size=(B, len(tp9.start)))
        U0 = torch.tensor(np.asarray(tp9.start) * (1.0 + 0.1 * xi),
                          dtype=torch.float64, device=dev)
        base = nls.NonlinearProblem(tp9.f, U0[0])
        bmesh = create_mesh(axis_names=("batch",))
        ref = nls.solve_ensemble(base, nls.SimpleNewtonRaphson(), u0s=U0,
                                 maxiters=200)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = nls.solve_ensemble(base, nls.SimpleNewtonRaphson(), u0s=U0,
                                 maxiters=200, mesh=bmesh)
        torch.cuda.synchronize()
        e_wall = time.perf_counter() - t0
        same = (isinstance(got.u, DTensor)
                and torch.equal(got.u.full_tensor(), ref.u)
                and torch.equal(got.retcode.full_tensor(), ref.retcode)
                and all(torch.equal(getattr(got.stats, k).full_tensor(),
                                    getattr(ref.stats, k))
                        for k in ("nf", "njacs", "nsteps")))
        emit({"phase": "slice18_ensemble_mesh", "batch": B,
              "engine": "SimpleNewtonRaphson", "rows_bit_equal": same,
              "placements": [str(p) for p in got.u.placements]
              if isinstance(got.u, DTensor) else None,
              "seconds": e_wall, "card": card})
        if not same:
            failed.append("(e) solve_ensemble(mesh=)")
        del got, ref, U0

        failed += _flagship_sharded_phase(torch, nls, _backend, brusselator,
                                          fft_poisson_preconditioner, mesh,
                                          card)
        failed += _dtensor_idioms_phase(torch, mesh, card)
    finally:
        dist.destroy_process_group()
    emit({"phase": "slice18_timing",
          "seconds": time.perf_counter() - t_phase, "card": card})
    if failed:
        raise AssertionError(f"phase 27 failed: {failed}")
    return k5_rec


def _dtensor_idioms_phase(torch, mesh, card):
    """Phase 27 (g): the residual idioms of ROADMAP C.10 (``torch.roll``,
    ``index_select``, ``X[..., idx]``) on a (64, 64, 2) f64 state under
    ``Shard(0)`` and ``Shard(1)`` (world size 1, NCCL): the AD J·v
    (``core.autodiff.jvp``, the VJP of the VJP on the DTensor) within
    1e-12 of ``torch.func.jvp`` on the whole tensor, in the state's
    placements, the residual equal; and which of the rules this torch
    takes from ``parallel/dtensor_rules.py``.  Returns the failed
    checks."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from nonlinearsolve_tpu_torch.core import autodiff
    from nonlinearsolve_tpu_torch.parallel import dtensor_rules
    aten = torch.ops.aten
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(27)
    X = torch.rand((64, 64, 2), generator=g, dtype=torch.float64,
                   device=dev) + 0.5
    T = torch.randn((64, 64, 2), generator=g, dtype=torch.float64,
                    device=dev)
    swap = torch.tensor([1, 0], device=dev)
    idioms = {
        "torch_roll": lambda U: U * torch.roll(U, 1, 0)
        - torch.roll(U, -1, 1),
        "index_select": lambda U: U * U.index_select(-1, swap),
        "index_tensor": lambda U: U * U[..., swap],
    }
    prop = DTensor._op_dispatcher.sharding_propagator
    port = {str(op): dtensor_rules.__name__ in getattr(
        getattr(fn, "func", fn), "__module__", "")
        for op in (aten.roll.default, aten.index_put.default,
                   aten.index_add.default)
        for fn in [prop.op_single_dim_strategy_funcs.get(op)
                   or prop.op_strategy_funcs.get(op)] if fn is not None}
    rows, failed = {}, []
    for name, f in idioms.items():
        for axis in (0, 1):
            key = f"{name} Shard({axis})"
            try:
                xs = distribute_tensor(X, mesh, [Shard(axis)],
                                       src_data_rank=None)
                ts = distribute_tensor(T, mesh, [Shard(axis)],
                                       src_data_rank=None)
                with implicit_replication():
                    fu, jv = autodiff.jvp(f, xs, ts)
                want_fu, want = torch.func.jvp(f, (X,), (T,))
                err = float((jv.full_tensor() - want).abs().max()
                            / want.abs().max())
                rows[key] = {"rel_err": err,
                             "placements": [str(q) for q in jv.placements],
                             "fu_equal": bool(torch.equal(fu.full_tensor(),
                                                          want_fu))}
                ok = (err <= 1e-12 and rows[key]["fu_equal"]
                      and rows[key]["placements"] == [str(Shard(axis))])
            except (RuntimeError, NotImplementedError, IndexError) as e:
                rows[key] = {"error": f"{type(e).__name__}: "
                                      f"{str(e).splitlines()[0]}"}
                ok = False
            if not ok:
                failed.append(f"(g) {key}")
    emit({"phase": "slice21_dtensor_idioms", "world_size": 1,
          "torch": torch.__version__, "port_rules": port, "cases": rows,
          "limit": 1e-12, "ok": not failed, "card": card})
    return failed


def _flagship_sharded_phase(torch, nls, _backend, brusselator,
                            fft_poisson_preconditioner, mesh, card):
    """Phase 27 (f): ``distributed_solve`` of the flagship's residual at
    512² f32 (phase 4's Newton–GMRES(8) with the FFT preconditioner,
    abstol 5) with the autodiff J·v (``kernel_jvp=False``), the state's
    rows and then its columns sharded, against the unsharded solve whose
    J·v is the same reverse-over-reverse product (``autodiff._reverse_jvp``
    as the problem's ``jvp``): equal retcode and nsteps, roots within 1e-4
    rel-inf, ``sol.u`` a DTensor in the requested placement.  The
    unsharded solve with the forward-mode J·v is recorded beside them: its
    product rounds otherwise, and at the f32 floor Newton's path parts
    from it (13 steps against 6 on the CPU).  Returns the failed checks."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from nonlinearsolve_tpu_torch.core import autodiff
    from nonlinearsolve_tpu_torch.parallel import distributed_solve
    N = 512
    flag, alg, _ = flagship_setup(torch, nls, brusselator,
                                  fft_poisson_preconditioner, N)
    f2 = brusselator.brusselator_2d
    prob = brusselator.problem(flag.u0, flag.p, kernel_jvp=False)
    prob_rev = nls.NonlinearProblem(nls.NonlinearFunction(
        f=f2, jvp=lambda v, u, p: autodiff._reverse_jvp(
            lambda U: f2(U, p), u, v)[1]), flag.u0, flag.p)

    def run(axis, problem=prob):
        torch.cuda.synchronize()
        _backend.reset_counters()
        t0 = time.perf_counter()
        if axis is None:
            sol = nls.solve(problem, alg, abstol=5.0, maxiters=30)
        else:
            sol = distributed_solve(problem, alg, mesh, shard_axis=axis,
                                    abstol=5.0, maxiters=30)
        torch.cuda.synchronize()
        u = sol.u.full_tensor() if isinstance(sol.u, DTensor) else sol.u
        return u, sol, {
            "wall_s": time.perf_counter() - t0, "retcode": sol.retcode.name,
            "stats": vars(sol.stats),
            "krylov_iters": sol.counters["krylov_iters"],
            "jac_products": sol.counters["jvp"],
            "host_reads": sol.counters["host_syncs"],
            "collectives": dict(_backend.COLLECTIVES),
            "launches": {k: v for k, v in _backend.LAUNCHES.items() if v}}

    def rel(u, w):
        return float((u - w).abs().max() / w.abs().max())

    run(None)                           # warms the FFT plans
    u_fwd, fwd, rec_fwd = run(None)
    u_rev, rev, rec_rev = run(None, prob_rev)
    rec_fwd["root_rel_inf_to_reverse"] = rel(u_fwd, u_rev)
    failed = [] if fwd.retcode == rev.retcode == nls.ReturnCode.Success \
        else ["(f) the unsharded flagship with the autodiff J·v"]
    runs = {}
    for axis in (0, 1):
        u, sol, rec = run(axis)
        rec["root_rel_inf_to_unsharded"] = rel(u, u_rev)
        rec["root_bit_equal"] = bool(torch.equal(u, u_rev))
        rec["placements"] = ([str(q) for q in sol.u.placements]
                             if isinstance(sol.u, DTensor) else None)
        us = distribute_tensor(flag.u0, mesh, [Shard(axis)],
                               src_data_rank=None)
        comm = CommDebugMode()
        with implicit_replication(), comm:
            autodiff.jvp(lambda U: f2(U, flag.p), us, us)
        rec["dtensor_collectives_per_jvp"] = {
            str(k): v for k, v in comm.get_comm_counts().items()}
        runs[f"Shard({axis})"] = rec
        if not (sol.retcode == rev.retcode
                and sol.stats.nsteps == rev.stats.nsteps
                and rec["root_rel_inf_to_unsharded"] <= 1e-4
                and rec["placements"] == [str(Shard(axis))]):
            failed.append(f"(f) the flagship residual under Shard({axis})")
        del u, sol, us

    def warm():
        distributed_solve(prob, alg, mesh, shard_axis=0, abstol=5.0,
                          maxiters=30)

    prof = profile_device(torch, warm, host_events=False)
    emit({"phase": "slice20_flagship_sharded", "N": N, "dtype": "float32",
          "jvp": "autodiff (kernel_jvp=False)", "world_size": 1,
          "unsharded_reverse": rec_rev, "unsharded_forward": rec_fwd,
          "sharded": runs, "limit": 1e-4,
          "note": "world size 1: each shard is the whole grid; a shard "
                  "fault shows only at world 2 and more (gloo tests)",
          "profile_shard0": prof, "card": card})
    return failed


def flagship_setup(torch, nls, brusselator, fft_poisson_preconditioner,
                   N):
    """Phase 4's flagship: the N² Brusselator in f32 with K1 as its JVP,
    Newton–GMRES(8) with the FFT Poisson preconditioner, Eisenstat–Walker
    forcing 0.1.  Returns ``(prob, alg, pm)``, ``pm`` the preconditioner;
    it is solved at abstol 5, 30 steps at most."""
    prob = brusselator.make_problem(N, torch.float32, kernel_jvp=True)
    pm = fft_poisson_preconditioner((N, N), alpha=10.0, h=1.0 / (N - 1),
                                    shift=3.0, n_components=2)
    alg = nls.NewtonRaphson(
        linsolve=nls.LinearSolver(method="gmres", restart=8,
                                  krylov_maxiter=100, precond_fn=pm),
        forcing=nls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))
    return prob, alg, pm


def polish_setup(torch, nls, brusselator, fft_poisson_preconditioner, N,
                 u0):
    """Phase 5's f64 polish from the flagship's root ``u0``: K1 in f64,
    Newton–GMRES(16) with the same preconditioner, forcing 1e-4.  Returns
    ``(prob64, alg64)``; it is solved at abstol 1e-4, 10 steps at most."""
    prob64 = brusselator.make_problem(N, torch.float64, kernel_jvp=True)
    prob64 = prob64.remake(u0=u0.double())
    pm64 = fft_poisson_preconditioner((N, N), alpha=10.0, h=1.0 / (N - 1),
                                      shift=3.0, n_components=2)
    alg64 = nls.NewtonRaphson(
        linsolve=nls.LinearSolver(method="gmres", restart=16,
                                  krylov_maxiter=200, precond_fn=pm64),
        forcing=nls.EisenstatWalkerForcing(eta_0=1e-4, eta_max=1e-4))
    return prob64, alg64


# ---------------------------------------------------------------------------
# Phase 28: lockstep first-order engines and ladders for ensembles, and the
# AOT round trip (see the module docstring).
LOCKSTEP_ROWS = 64
LOCKSTEP_P9_B = 65536          # (a): problem 9's starts
LOCKSTEP_BRUSSELATOR_B = 1024  # (b): the 8×8 Brusselator's values of A
LADDER_LONE_ROWS = 8           # (b): the default ladder's rows solved alone


def _lockstep_engines(nls):
    return {
        "NewtonRaphson": nls.NewtonRaphson,
        "NewtonRaphson+BackTracking": lambda: nls.NewtonRaphson(
            linesearch=nls.BackTracking()),
        "TrustRegion": nls.TrustRegion,
        "TrustRegion-Fan": lambda: nls.TrustRegion(
            radius_update_scheme="fan"),
        "LevenbergMarquardt": nls.LevenbergMarquardt,
        "default ladder": lambda: None,
    }


@contextlib.contextmanager
def rows_one_by_one():
    """The lockstep engines with every product and norm taken one row at a
    time, as the lone engines take it: ``core/lockstep.py``'s CPU branch
    (each row's own gemv and dot) applied to CUDA tensors, and the rows'
    norms and dots of ``solvers/first_order_lockstep.py`` and
    ``core/termination.py`` one row at a time.  Under it a lockstep row
    rounds as its lone solve does but for the batched residual and square
    solves: the witness that tells the batched products' rounding from a
    defect of the batch."""
    import torch
    from nonlinearsolve_tpu_torch.core import termination as trm
    from nonlinearsolve_tpu_torch.solvers import first_order_lockstep as fol

    def norm_rows(name, x):
        order = float("inf") if name == "linf" else 2
        return torch.stack([torch.linalg.vector_norm(r, ord=order)
                            for r in x])
    swaps = [
        (fol, "rows_matvec",
         lambda A, x: torch.stack([a @ v for a, v in zip(A, x)])),
        (fol, "rows_vecmat",
         lambda x, A: torch.stack([v @ a for v, a in zip(x, A)])),
        (fol, "rows_dot",
         lambda a, b: torch.stack([torch.dot(x, y) for x, y in zip(a, b)])),
        (fol, "_dot",
         lambda a, b: torch.stack([(x * y).sum() for x, y in zip(a, b)])),
        (fol, "_l2", lambda x: norm_rows("l2", x)),
        (trm, "_rows_norm", norm_rows)]
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in kept:
            setattr(mod, name, fn)


def _lockstep_run(torch, nls, _backend, name, make, base, card, u0s=None,
                  ps=None, f=None, abstol=3.0e-13, lone_rows=None,
                  witness=False):
    """One lockstep ensemble on the card: its report, the reads at 64 rows
    and at those rows 16 times over, and the ``lone_rows``
    solved alone, each with the batch row's retcode, NLStats and a root
    within 1e-12.  With ``witness`` (a run of about a thousand steps,
    where the batched products' rounding may move a stop) a row whose
    batch NLStats part from its lone solve's passes only if, run again
    with the other parting rows as one lockstep batch under
    ``rows_one_by_one``, it has its lone NLStats, retcode and a root
    within 1e-12; the first two of those rows (two lone rows when none
    part) are also run twice over there, with the same reads and rows
    within 1e-12, and two parting rows as lockstep batches of one row
    (recorded).  The 64-row and 1024-row reads are then not taken.
    Returns (the record, whether its checks held, the solution)."""
    kw = {"abstol": abstol}
    batch = u0s if u0s is not None else ps
    B = batch.shape[0]

    def ens(rows=None):
        pick = (lambda x: x) if rows is None else (lambda x: x[rows])
        return nls.solve_ensemble(
            base, make(), u0s=None if u0s is None else pick(u0s),
            ps=None if ps is None else pick(ps), **kw)

    sol, rec = batched_run_report(torch, _backend, ens, name, B, card)
    codes = dict(zip(*[t.tolist() for t in torch.unique(
        sol.retcode, return_counts=True)]))
    ok_rows = sol.retcode == int(nls.ReturnCode.Success)
    worst = (float(torch.func.vmap(f)(sol.u[ok_rows], *(
        () if ps is None else (ps[ok_rows],))).abs().max())
        if bool(ok_rows.any()) else 0.0)
    reads = {"host_reads_64_rows": "not measured",
             "host_reads_1024_rows": "not measured"}
    reads_equal, tiled_equal, tiled_rel = True, None, 0.0
    rows = torch.as_tensor(lone_rows, device=batch.device)
    if not witness:
        small = ens(rows)
        big = ens(rows.repeat(16))
        reads = {"host_reads_64_rows": small.counters["host_syncs"],
                 "host_reads_1024_rows": big.counters["host_syncs"]}
        reads_equal = (reads["host_reads_64_rows"]
                       == reads["host_reads_1024_rows"])
        # cuBLAS's batched products may round otherwise at another batch
        # size
        tiled_u = small.u.repeat((16,) + (1,) * (small.u.dim() - 1))
        tiled_equal = bool(torch.equal(big.u, tiled_u))
        tiled_rel = _rel_inf(big.u.reshape(-1), tiled_u.reshape(-1))
    lones, t0 = [], time.perf_counter()
    for i in lone_rows:
        lones.append(nls.solve(base.remake(
            u0=base.u0 if u0s is None else u0s[i],
            p=base.p if ps is None else ps[i]), make(), **kw))
    torch.cuda.synchronize()
    lone_s = time.perf_counter() - t0
    bad, diffs = [], []
    for k, (i, lone) in enumerate(zip(lone_rows, lones)):
        rel = _rel_inf(lone.u.reshape(-1), sol.u[i].reshape(-1))
        row = {"row": int(i), "lone": int(lone.retcode),
               "batch": int(sol.retcode[i]), "rel_inf": rel,
               "lone_stats": _stats_dict(lone.stats),
               "batch_stats": _stats_dict(sol.stats, i)}
        if row["lone_stats"] != row["batch_stats"]:
            diffs.append(k)
        if int(lone.retcode) != int(sol.retcode[i]) or not rel <= 1e-12:
            bad.append(row)
        elif row["lone_stats"] != row["batch_stats"] and not witness:
            bad.append(row)
    out = {"route": sol.counters["ensemble_route"], "retcodes": codes,
           "success_resid_inf_max": worst, "abstol": abstol,
           **reads, "tiled_rows_bit_equal": tiled_equal,
           "tiled_rows_rel_inf": tiled_rel,
           "lone_checked": len(lone_rows),
           "lone_stats_differences": len(diffs),
           "lone_stats_difference_examples": [
               {"row": int(lone_rows[k]),
                "lone": _stats_dict(lones[k].stats),
                "batch": _stats_dict(sol.stats, lone_rows[k])}
               for k in diffs[:4]],
           "lone_seconds": lone_s,
           "lone_seconds_per_row": lone_s / len(lone_rows),
           "batch_seconds_per_row": rec["warm_wall_s_one"] / B}
    if witness:
        # the parting rows (else two lone rows, for the reads) one row at a
        # time; the first two of them also twice over
        t1 = time.perf_counter()
        wk = diffs or list(range(min(2, len(lone_rows))))
        wrows = rows[wk]
        with rows_one_by_one():
            one = ens(wrows)
            pair = one if len(wk) <= 2 else ens(wrows[:2])
            two = ens(wrows[:2].repeat(2))
        w_bad, w_bits = [], 0
        for j, k in enumerate(wk):
            lone = lones[k]
            got = {"row": int(lone_rows[k]), "lone": int(lone.retcode),
                   "witness": int(one.retcode[j]),
                   "rel_inf": _rel_inf(lone.u.reshape(-1),
                                       one.u[j].reshape(-1)),
                   "lone_stats": _stats_dict(lone.stats),
                   "witness_stats": _stats_dict(one.stats, j)}
            w_bits += bool(torch.equal(lone.u.reshape(-1),
                                       one.u[j].reshape(-1)))
            if (got["lone"] != got["witness"] or not got["rel_inf"] <= 1e-12
                    or got["lone_stats"] != got["witness_stats"]):
                w_bad.append(got)
        w_reads = [pair.counters["host_syncs"], two.counters["host_syncs"]]
        w_twice_rel = _rel_inf(two.u.reshape(-1),
                               torch.cat([pair.u, pair.u]).reshape(-1))
        w_s = time.perf_counter() - t1
        # two parting rows as lockstep batches of one row (not one by one)
        b1 = {}
        for k in diffs[:2]:
            s1 = ens(rows[k:k + 1])
            b1[int(lone_rows[k])] = {
                "stats": _stats_dict(s1.stats, 0),
                "equal_lone_stats": (_stats_dict(s1.stats, 0)
                                     == _stats_dict(lones[k].stats)),
                "bit_equal_lone": bool(torch.equal(
                    s1.u[0].reshape(-1), lones[k].u.reshape(-1)))}
        out.update({
            "witness_rows_one_by_one": {
                "rows": [int(lone_rows[k]) for k in wk],
                "failures": w_bad[:4], "failure_count": len(w_bad),
                "roots_bit_equal_lone": w_bits,
                "host_reads_two_rows_and_twice": w_reads,
                "twice_rows_rel_inf": w_twice_rel,
                "seconds": w_s},
            "parting_rows_at_B1": b1})
        bad += w_bad
        reads_equal = w_reads[0] == w_reads[1] and w_twice_rel <= 1e-12
    ok = (out["route"] == "lockstep" and not rec["custom_kernel_launches"]
          and worst <= abstol and reads_equal and tiled_rel <= 1e-12
          and not bad)
    out.update({"lone_failures": bad[:3], "lone_failure_count": len(bad),
                **rec, "ok": ok})
    return out, ok, sol


def _brusselator_jac(torch, N, dev):
    """The N² Brusselator's Jacobian written out, ``jac(U, p)`` -> (2N²,
    2N²) dense: the periodic 5-point Laplacian times α/dx² on each
    component plus the 2×2 reaction block of each point, its 12 nonzeros
    a point put once each (no accumulation, so no order of sums)."""
    import numpy as np
    k = np.arange(N * N * 2).reshape(N, N, 2)
    nb = [np.roll(k, s, a) for s, a in ((1, 0), (-1, 0), (1, 1), (-1, 1))]
    rows = np.concatenate([k.ravel()] * 4 + [k.ravel(), k[..., 0].ravel(),
                                             k[..., 1].ravel()])
    cols = np.concatenate([b.ravel() for b in nb]
                          + [k.ravel(), k[..., 1].ravel(),
                             k[..., 0].ravel()])
    rows = torch.tensor(rows, device=dev)
    cols = torch.tensor(cols, device=dev)
    n = 2 * N * N

    def jac(U, p):
        A, B, alpha = p[0], p[1], p[2] / p[3] ** 2
        u, v = U[..., 0], U[..., 1]
        uv = u * v
        diag = torch.stack([2.0 * uv - (A + 1.0) - 4.0 * alpha,
                            -(u * u) - 4.0 * alpha], -1)
        side = alpha * torch.ones(4 * n, dtype=U.dtype, device=U.device)
        vals = torch.cat([side, diag.reshape(-1), (u * u).reshape(-1),
                          (A - 2.0 * uv).reshape(-1)])
        J = torch.zeros((n, n), dtype=U.dtype, device=U.device)
        return J.index_put((rows, cols), vals)
    return jac


def _aot_carried_phase(torch, nls, brusselator, card):
    """Phase 28 (d): templates that carry more than the residual (ROADMAP
    C.8) round-tripped on the card at N = 32, f64: the Brusselator with
    its Jacobian written out (``jac``), Newton–GMRES(8) with the FFT
    Poisson preconditioner made by its factory (crossing as the factory's
    call), and the state as a dict of its two components.  Each loaded
    solve bit for bit the in-process solve, retcode and NLStats equal, on
    a fresh p.  Returns the failed checks."""
    from nonlinearsolve_tpu_torch.ops.preconditioners import (
        fft_poisson_preconditioner)
    dev, f64, N = torch.device("cuda"), torch.float64, 32
    base = brusselator.make_problem(N, f64, device=dev)
    f2 = brusselator.brusselator_2d
    p2 = base.p.clone()
    p2[0] = 3.1

    def dict_f(d, p):
        out = f2(torch.stack([d["u"], d["v"]], -1), p)
        return {"u": out[..., 0], "v": out[..., 1]}

    pm = fft_poisson_preconditioner((N, N), alpha=10.0, h=1.0 / (N - 1),
                                    shift=3.0, n_components=2)
    gmres = nls.NewtonRaphson(linsolve=nls.LinearSolver(
        method="gmres", restart=8, krylov_maxiter=200, precond_fn=pm))
    cases = {
        "jac": (nls.NonlinearProblem(nls.NonlinearFunction(
            f2, jac=_brusselator_jac(torch, N, dev)), base.u0, base.p),
            nls.NewtonRaphson(), base.u0),
        "fft_factory": (nls.NonlinearProblem(f2, base.u0, base.p), gmres,
                        base.u0),
        "dict_state": (nls.NonlinearProblem(dict_f, {
            "u": base.u0[..., 0].clone(), "v": base.u0[..., 1].clone()},
            base.p), nls.NewtonRaphson(), {"u": base.u0[..., 0].clone(),
                                           "v": base.u0[..., 1].clone()}),
    }
    rows, failed = {}, []
    for name, (prob, alg, u0) in cases.items():
        t0 = time.perf_counter()
        data = nls.export_solver(prob, alg, abstol=1e-10)
        export_s = time.perf_counter() - t0
        got = nls.deserialize_solver(data)(u0, p2)
        ref = nls.solve(prob.remake(u0=u0, p=p2), alg, abstol=1e-10)
        torch.cuda.synchronize()
        gu = got.u if isinstance(got.u, dict) else {"u": got.u}
        ru = ref.u if isinstance(ref.u, dict) else {"u": ref.u}
        same = (gu.keys() == ru.keys()
                and all(bit_equal(torch, gu[k], ru[k]) for k in gu)
                and int(got.retcode) == int(ref.retcode)
                and _stats_dict(got.stats) == _stats_dict(ref.stats))
        rows[name] = {"artifact_bytes": len(data), "export_s": export_s,
                      "retcode": int(got.retcode),
                      "stats": _stats_dict(got.stats),
                      "on_card": all(v.device.type == "cuda"
                                     for v in gu.values()),
                      "bit_equal_to_solve": same}
        if not (same and rows[name]["on_card"]
                and got.retcode == nls.ReturnCode.Success):
            failed.append(f"(d) {name}")
    emit({"phase": "slice21_aot_carried", "N": N, "dtype": "float64",
          "cases": rows, "ok": not failed, "card": card})
    return failed


def lockstep_phase(torch, nls, _backend, brusselator, card):
    """Phase 28 (see the module docstring)."""
    import numpy as np
    from nonlinearsolve_tpu_torch.models import problems23 as p23
    dev, f64 = torch.device("cuda"), torch.float64
    t_phase = time.perf_counter()
    failed = []
    pick = np.random.default_rng(2819)

    # (a) problem 9, n = 10, 65,536 seeded starts
    B = LOCKSTEP_P9_B
    tp9 = p23.PROBLEMS_23[8]
    xi = np.random.default_rng(28).uniform(-1.0, 1.0, size=(B, 10))
    U0 = torch.tensor(tp9.start * (1.0 + 0.5 * xi), dtype=f64, device=dev)
    base = nls.NonlinearProblem(tp9.f, U0[0])
    rows = sorted(pick.choice(B, LOCKSTEP_ROWS, replace=False).tolist())
    # the profiles read the raw events: held once against key_averages()
    if not device_time_sources_agree(torch, lambda: nls.solve_ensemble(
            base, nls.NewtonRaphson(), u0s=U0[:4096]), card):
        failed.append("device time sources")
    for name, make in _lockstep_engines(nls).items():
        t0 = time.perf_counter()
        rec, ok, sol = _lockstep_run(torch, nls, _backend, name, make, base,
                                     card, u0s=U0, f=tp9.f, lone_rows=rows)
        emit({"phase": "lockstep_problem9", "engine": name, "n": 10,
              "seconds": time.perf_counter() - t0, **rec})
        if not ok:
            failed.append(f"(a) {name}")
        del sol

    # (b) the 8×8 dense Brusselator (128 unknowns) over 1024 values of A
    B = LOCKSTEP_BRUSSELATOR_B
    bp = brusselator.make_problem(8, f64, device=dev)
    ps = bp.p[None, :].repeat(B, 1)
    ps[:, 0] = torch.tensor(np.random.default_rng(281).uniform(2.5, 4.5, B),
                            dtype=f64, device=dev)
    rows = sorted(pick.choice(B, LOCKSTEP_ROWS, replace=False).tolist())
    f_b = brusselator.brusselator_2d
    for name, make in _lockstep_engines(nls).items():
        if name not in ("NewtonRaphson", "TrustRegion", "default ladder"):
            continue
        # the default ladder's rows take about 1000 steps (Broyden ends
        # Unstable or Stalled after 20-60, Klement at its 1000), 1.7-2.6 s
        # a row alone: 8 rows are checked, and the batched products'
        # rounding, which may move Broyden's stop, is told from a defect
        # by the witness (``rows_one_by_one``)
        ladder = name == "default ladder"
        t0 = time.perf_counter()
        rec, ok, sol = _lockstep_run(
            torch, nls, _backend, name, make, bp, card, ps=ps, f=f_b,
            abstol=1e-10, lone_rows=rows[:LADDER_LONE_ROWS] if ladder
            else rows, witness=ladder)
        emit({"phase": "lockstep_brusselator8", "engine": name, "n": 128,
              "seconds": time.perf_counter() - t0, **rec})
        if not ok:
            failed.append(f"(b) {name}")
        del sol
    del ps

    # (c) the AOT round trip: NewtonRaphson on the N = 32 dense Brusselator
    prob = brusselator.make_problem(32, f64, device=dev)
    t0 = time.perf_counter()
    data = nls.export_solver(prob, nls.NewtonRaphson(), abstol=1e-10)
    export_s = time.perf_counter() - t0
    solver = nls.deserialize_solver(data)
    p2 = prob.p.clone()
    p2[0] = 3.1
    _backend.reset_counters()
    got = solver(prob.u0, p2)
    torch.cuda.synchronize()
    walls = warm_walls(torch, lambda: solver(prob.u0, p2))
    ref = nls.solve(prob.remake(p=p2), nls.NewtonRaphson(), abstol=1e-10)
    ref_walls = warm_walls(torch, lambda: nls.solve(
        prob.remake(p=p2), nls.NewtonRaphson(), abstol=1e-10))
    bit_equal = (bool(torch.equal(got.u, ref.u))
                 and int(got.retcode) == int(ref.retcode)
                 and _stats_dict(got.stats) == _stats_dict(ref.stats))
    batch_solver = nls.deserialize_solver(nls.export_solver(
        prob, nls.NewtonRaphson(), batch="b", abstol=1e-10))
    batches = []
    for n in (2, 5):
        pb = prob.p[None, :].repeat(n, 1)
        pb[:, 0] = torch.linspace(3.0, 3.8, n, dtype=f64, device=dev)
        u0b = prob.u0[None].repeat(n, 1, 1, 1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sols = batch_solver(u0b, pb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        worst = max(_rel_inf(nls.solve(prob.remake(p=pb[i]),
                                       nls.NewtonRaphson(),
                                       abstol=1e-10).u.reshape(-1),
                             sols.u[i].reshape(-1)) for i in range(n))
        batches.append({"B": n, "route": sols.counters["ensemble_route"],
                        "retcodes": sols.retcode.tolist(),
                        "rel_inf_to_lone_max": worst, "wall_s": wall})
    ok = (bit_equal and got.u.device.type == "cuda"
          and all(b["route"] == "lockstep" and b["rel_inf_to_lone_max"]
                  <= 1e-12 and set(b["retcodes"]) == {1} for b in batches))
    emit({"phase": "lockstep_aot", "N": 32, "n": 2048,
          "artifact_bytes": len(data), "export_s": export_s,
          "bit_equal_to_solve": bit_equal, "retcode": int(got.retcode),
          "nsteps": int(got.stats.nsteps),
          "warm_walls_s": walls, "solve_warm_walls_s": ref_walls,
          "batched": batches, "ok": ok, "card": card})
    if not ok:
        failed.append("(c)")
    failed += _aot_carried_phase(torch, nls, brusselator, card)
    emit({"phase": "lockstep_done",
          "phase_seconds": time.perf_counter() - t_phase, "card": card})
    if failed:
        raise AssertionError(f"lockstep phase failed: {failed}")


def only_phases(torch, nls, _backend, brusselator, stencil, spmv,
                fft_poisson_preconditioner, card, phases):
    """``--only``: phases 19–28 alone, in the order given, each on the
    set-up it takes from the earlier phases rebuilt here: phase 18's
    NewtonRaphson root at N=32 for 20; the flagship and its polish, solved
    as phases 4 and 5 solve them, for 23, 26 and 27; the flagship's problem
    and algorithm for 24; phase 7's Jacobian at its root and phase 10's
    root for 27 (``slice18_setup``)."""
    f64 = torch.float64
    for ph in phases:
        t0 = time.perf_counter()
        if ph == "19":
            problems23_phase(torch, nls, _backend, card)
        elif ph == "20":
            nr_root = nls.solve(brusselator.make_problem(32, f64),
                                nls.NewtonRaphson(), abstol=1e-10).u
            qn_polyalg_phase(torch, nls, _backend, brusselator, nr_root,
                             card)
        elif ph == "21":
            sparse_direct_phase(torch, nls, _backend, spmv, card)
        elif ph == "22":
            batched_tier_phase(torch, nls, _backend, card)
        elif ph == "23":
            prob, alg, _pm = flagship_setup(torch, nls, brusselator,
                                            fft_poisson_preconditioner, 512)
            sol = nls.solve(prob, alg, abstol=5.0, maxiters=30)
            prob64, alg64 = polish_setup(torch, nls, brusselator,
                                         fft_poisson_preconditioner, 512,
                                         sol.u)
            sensitivity_phase(torch, nls, _backend, brusselator, stencil,
                              spmv, card, prob, alg, prob64, alg64)
        elif ph == "24":
            prob, alg, _pm = flagship_setup(torch, nls, brusselator,
                                            fft_poisson_preconditioner, 512)
            continuation_phase(torch, nls, _backend, card, prob, alg)
        elif ph == "25":
            a33_phase(torch, nls, _backend, brusselator,
                      fft_poisson_preconditioner, card)
        elif ph == "27":
            prob, alg, pm = flagship_setup(torch, nls, brusselator,
                                           fft_poisson_preconditioner, 512)
            sol = nls.solve(prob, alg, abstol=5.0, maxiters=30)
            prob64, alg64 = polish_setup(torch, nls, brusselator,
                                         fft_poisson_preconditioner, 512,
                                         sol.u)
            u64 = nls.solve(prob64, alg64, abstol=1e-4, maxiters=10).u
            csr7, rd3d = slice18_setup(torch, nls, brusselator,
                                       fft_poisson_preconditioner)
            slice18_phase(torch, nls, _backend, brusselator, spmv,
                          fft_poisson_preconditioner, card, u64, csr7, rd3d)
        elif ph == "26":
            prob, alg, pm = flagship_setup(torch, nls, brusselator,
                                           fft_poisson_preconditioner, 512)
            sol = nls.solve(prob, alg, abstol=5.0, maxiters=30)
            prob64, alg64 = polish_setup(torch, nls, brusselator,
                                         fft_poisson_preconditioner, 512,
                                         sol.u)
            sol64 = nls.solve(prob64, alg64, abstol=1e-4, maxiters=10)
            slice17_phase(torch, nls, _backend, brusselator, stencil,
                          fft_poisson_preconditioner, card, sol, pm,
                          sol64.u, None)
        elif ph == "28":
            lockstep_phase(torch, nls, _backend, brusselator, card)
        else:
            raise ValueError(f"--only takes phases 19 to 28, not {ph!r}")
        emit({"phase": "only_phase", "only": ph,
              "seconds": time.perf_counter() - t0, "card": card})


def main(argv):
    import torch

    if "--poly-reference" in argv:
        return poly_cpu_reference(argv)
    if "--log" in argv:
        LOG["path"] = argv[argv.index("--log") + 1]
        os.makedirs(os.path.dirname(os.path.abspath(LOG["path"])),
                    exist_ok=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import nonlinearsolve_tpu_torch as nls
    from nonlinearsolve_tpu_torch import _backend, native
    from nonlinearsolve_tpu_torch.models import brusselator, reaction_diffusion
    from nonlinearsolve_tpu_torch.ops import spmv, stencil, stencil3d
    from nonlinearsolve_tpu_torch.ops.preconditioners import (
        fft_poisson_preconditioner)
    from nonlinearsolve_tpu_torch.utils import profiling

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # --- 2. build: one compiler per source, all started together ------------
    def timed_build(build):
        t = time.perf_counter()
        so = build()
        return so, time.perf_counter() - t

    t0 = time.perf_counter()
    builds = {"stencil": lambda: _backend.build("stencil"),
              "spmv": lambda: _backend.build("spmv"),
              "stencil3d": lambda: _backend.build("stencil3d"),
              "rd3d_designs": lambda: build_rd3d_designs(_backend),
              "sparsetools": native.build}
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {k: pool.submit(timed_build, b) for k, b in builds.items()}
        built = {k: f.result() for k, f in futures.items()}
    stencil._lib()
    spmv._lib()
    stencil3d._lib()
    native.get_lib()
    column = ColumnRd3d(torch, _backend, stencil3d, built["rd3d_designs"][0])
    build_s = time.perf_counter() - t0
    for name, (so, secs) in built.items():
        ptxas = [ln.strip() for ln in _backend.BUILD_LOGS.get(name, "")
                 .splitlines() if "registers" in ln or "spill" in ln]
        rec = {"phase": "build", "source": name, "seconds": secs,
               "library": so.name, "ptxas": ptxas}
        if name == "stencil":
            rec["sass_instructions"] = sass_counts(so)
        emit(rec)
    emit({"phase": "build", "seconds": build_s})

    if "--only" in argv:
        only_phases(torch, nls, _backend, brusselator, stencil, spmv,
                    fft_poisson_preconditioner, card,
                    argv[argv.index("--only") + 1].split(","))
        emit({"phase": "only", "seconds": time.perf_counter() - t_start})
        return 0

    # --- 3. kernels against their plain versions ---------------------------
    gen = torch.Generator().manual_seed(0)

    def inputs(N, dtype):
        return brusselator_inputs(torch, brusselator, dev, gen, N, dtype)

    timings = stencil_timings(torch, stencil, inputs, card)
    # the launches of a wrapper call: one for K1, K3 and the bf16 matvec on
    # an f32 tangent; two for K2 (its max's word zeroed, then K2), with a
    # float and a tensor inv_scale, both layouts
    per_call = {f"{case} N={N} {d}": r["launches_per_call"]
                for (case, N, d), r in timings.items()
                if case != "chain_step"}
    expected = {key: 2 if key.startswith("brusselator_jvp_scaled") else 1
                for key in per_call}
    emit({"phase": "kernels_per_wrapper_call", "counts": per_call,
          "ok": per_call == expected})
    if per_call != expected:
        raise AssertionError(f"a wrapper launched other than {expected}: "
                             f"{per_call}")

    summary = {}
    for N in (512, 2048):
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[-1]
            U, T, p = inputs(N, dtype)
            planes = [U[..., 0].contiguous(), U[..., 1].contiguous(),
                      T[..., 0].contiguous(), T[..., 1].contiguous()]
            cases = {
                "brusselator_jvp": (
                    lambda: stencil.brusselator_jvp(U, T, p),
                    lambda: stencil.brusselator_jvp_plain(U, T, p)),
                "brusselator_jvp_scaled": (
                    lambda: stencil.brusselator_jvp_scaled(U, T, p, 0.5),
                    lambda: stencil.brusselator_jvp_scaled_plain(U, T, p,
                                                                 0.5)),
                "brusselator_jvp_scaled_pair": (
                    lambda: stencil.brusselator_jvp_scaled_pair(*planes, p,
                                                                0.5),
                    lambda: stencil.brusselator_jvp_scaled_pair_plain(
                        *planes, p, 0.5)),
            }
            for case, (kern, plain) in cases.items():
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                if case == "brusselator_jvp":
                    out, out_ref, mx_err = got, ref, 0.0
                elif case == "brusselator_jvp_scaled":
                    out, out_ref = got[0], ref[0]
                    mx_err = rel_err(got[1], ref[1])[1]
                else:
                    out = torch.stack(got[:2], -1)
                    out_ref = torch.stack(ref[:2], -1)
                    mx_err = rel_err(got[2], ref[2])[1]
                abs_err, rel = rel_err(out, out_ref)
                # K2's max is max|out| of its own output, exactly
                own_max = (case == "brusselator_jvp" or bool(
                    torch.equal(got[-1], out.abs().max())))
                ok = rel <= TOL[dname] and mx_err <= TOL[dname] and own_max
                t = timings[(case, N, dname)]
                plain_ms = graph_time_ms(torch, plain, calls=10, replays=20)
                rec = {"phase": "kernel_check", "case": case, "N": N,
                       "dtype": dname, "max_abs_err": abs_err,
                       "rel_err": rel, "absmax_rel_err": mx_err,
                       "absmax_equals_own_max": own_max,
                       "tolerance": TOL[dname], "ms": t["ms"],
                       "plain_ms": plain_ms, "bound_ms": t["bound_ms"],
                       "bound_by": t["bound_by"],
                       "share_of_bound": t["share_of_bound"], "ok": ok}
                emit(rec)
                if not ok:
                    raise AssertionError(f"{case} N={N} {dname} disagrees "
                                         f"with its plain version: {rec}")
                if dtype == torch.float32:
                    summary[(case, N)] = rec
            # a NaN in the tangent must reach K2's absmax
            Tn = T.clone()
            Tn[7, 11, 1] = float("nan")
            m_k = stencil.brusselator_jvp_scaled(U, Tn, p, 0.5)[1]
            m_p = stencil.brusselator_jvp_scaled_pair(
                planes[0], planes[1], Tn[..., 0].contiguous(),
                Tn[..., 1].contiguous(), p, 0.5)[2]
            nan_ok = bool(torch.isnan(m_k)) and bool(torch.isnan(m_p))
            emit({"phase": "kernel_nan", "N": N, "dtype": dname,
                  "absmax": [float(m_k), float(m_p)], "ok": nan_ok})
            if not nan_ok:
                raise AssertionError("K2's absmax dropped a NaN")
            del U, T, p, planes, Tn
    k2_graph_replay_checks(torch, stencil, inputs)
    k3_summary = k3_kernel_checks(torch, stencil, inputs, timings)

    from nonlinearsolve_tpu_torch.ops.sparse_jac import plan_sparse_jacobian
    spmv_summary = sparse_kernel_checks(torch, dev, spmv, brusselator,
                                        plan_sparse_jacobian)

    # --- 4. main path ------------------------------------------------------
    N = 512
    f32 = torch.float32
    prob, alg, pm = flagship_setup(torch, nls, brusselator,
                                   fft_poisson_preconditioner, N)
    chain_steps = 1000

    def chain(steps):
        # bench.py:92-108: scale-on-read, absmax fed back as the next scale
        c = torch.ones_like(prob.u0)
        s = torch.ones((), dtype=f32, device=dev)
        for _ in range(steps):
            c, m = stencil.brusselator_jvp_scaled(prob.u0, c, prob.p,
                                                  1.0 / s)
            s = torch.clamp(m, min=1.0)
        return c, s

    torch.cuda.synchronize()
    _backend.reset_counters()
    t0 = time.perf_counter()
    c_out, s_out = chain(chain_steps)
    torch.cuda.synchronize()
    chain_wall_ms = (time.perf_counter() - t0) * 1e3 / chain_steps
    t0 = time.perf_counter()
    sol = nls.solve(prob, alg, abstol=5.0, maxiters=30)
    torch.cuda.synchronize()
    solve_first_s = time.perf_counter() - t0
    launches = dict(_backend.LAUNCHES)
    syncs = _backend.HOST_SYNCS["n"]

    resid_inf = float(sol.resid.abs().max())
    forced = int((brusselator.brusselator_2d(
        torch.zeros_like(prob.u0), prob.p)[..., 0] > 3).sum())
    chain_ok = bool(torch.isfinite(c_out).all()) and bool(
        torch.isfinite(s_out))
    rec = {"phase": "main_path", "N": N, "dtype": "float32",
           "retcode": sol.retcode.name, "resid_inf": resid_inf,
           "abstol": 5.0, "forced_points": forced,
           "nsteps": sol.stats.nsteps, "stats": vars(sol.stats),
           "krylov_iters": sol.counters["krylov_iters"],
           "jvp": sol.counters["jvp"], "launches": launches,
           "host_syncs": sol.counters["host_syncs"],
           "host_syncs_per_newton_step":
               sol.counters["host_syncs"] / max(sol.stats.nsteps, 1),
           "host_syncs_counted": syncs,
           "chain_steps": chain_steps, "chain_finite": chain_ok,
           "first_solve_s": solve_first_s}
    emit(rec)
    checks = {
        "retcode Success": sol.retcode == nls.ReturnCode.Success,
        "|resid|_inf <= 5": resid_inf <= 5.0,
        "8204 forced points": forced == 8204 == int(
            brusselator.forcing_mask(N, f32).sum()),
        "K1 launches == Jacobian products":
            launches["brusselator_jvp"] == sol.counters["jvp"] > 0,
        "K2 launches == chain steps":
            launches["brusselator_jvp_scaled"] == chain_steps,
        "chain finite": chain_ok,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"main path failed: {failed}")

    # warm solves, host clock between two synchronizes
    def warm_solve():
        warm = nls.solve(prob, alg, abstol=5.0, maxiters=30)
        if warm.retcode != nls.ReturnCode.Success:
            raise AssertionError(f"warm solve: {warm.retcode.name}")

    walls = warm_walls(torch, warm_solve)
    # device busy time of one warm solve, from the profiler
    prof = profile_device(torch, warm_solve)
    carry = {"c": torch.ones_like(prob.u0),
             "s": torch.ones((), dtype=f32, device=dev)}

    def chain_step():
        carry["c"], m = stencil.brusselator_jvp_scaled(
            prob.u0, carry["c"], prob.p, 1.0 / carry["s"])
        carry["s"] = torch.clamp(m, min=1.0)

    chain_graph_ms = graph_time_ms(torch, chain_step, calls=100, replays=4)
    emit({"phase": "main_path_timing", "warm_solve_s": walls,
          "warm_solve_s_median": sorted(walls)[1], **prof,
          "chain_step_ms_eager": chain_wall_ms,
          "chain_step_ms_graph": chain_graph_ms,
          "chain_gnnz_per_s_graph": 12 * N * N / chain_graph_ms / 1e6,
          "card": card})

    # --- 5. f64 polish -----------------------------------------------------
    prob64, alg64 = polish_setup(torch, nls, brusselator,
                                 fft_poisson_preconditioner, N, sol.u)
    t0 = time.perf_counter()
    sol64 = nls.solve(prob64, alg64, abstol=1e-4, maxiters=10)
    torch.cuda.synchronize()
    polish_s = time.perf_counter() - t0
    u64 = sol64.u
    scale = max(float(u64.abs().max()), 1.0)
    dist = float((sol.u.double() - u64).abs().max()) / scale
    emit({"phase": "f64_polish", "retcode": sol64.retcode.name,
          "nsteps": sol64.stats.nsteps,
          "krylov_iters": sol64.counters["krylov_iters"],
          "resid_inf": float(sol64.resid.abs().max()),
          "f32_root_rel_inf_distance": dist, "limit": 1e-2,
          "seconds": polish_s})
    if sol64.retcode != nls.ReturnCode.Success or not dist <= 1e-2:
        raise AssertionError(f"f64 polish: {sol64.retcode.name}, "
                             f"distance {dist}")

    # --- 6. sparse path: colored AD into DIA, f64 N=512 ---------------------
    import numpy as np
    from nonlinearsolve_tpu_torch.core import solve as solve_mod
    f64 = torch.float64
    n = 2 * N * N
    # time the one-time host plan from empty caches (phase 3 filled them)
    spmv.clear_plan_caches()
    t0 = time.perf_counter()
    pat = brusselator.sparsity_pattern(N)
    t_pattern = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_plan = plan_sparse_jacobian(None, n, n, sparsity=pat)
    t_coloring = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_plan.dia_plan
    t_tier = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_plan.dia_selection.table(dev)
    torch.cuda.synchronize()
    t_tables = time.perf_counter() - t0
    emit({"phase": "sparse_plan", "N": N, "pattern_s": t_pattern,
          "coloring_s": t_coloring, "tier_selection_s": t_tier,
          "selection_tables_s": t_tables,
          "host_plan_s": t_pattern + t_coloring + t_tier + t_tables,
          "nnz": pat.nnz, "n_colors": host_plan.n_colors,
          "ndiag": host_plan.dia_plan.ndiag,
          "offsets": list(host_plan.dia_plan.offsets)})
    del host_plan

    sprob = flat_problem(nls, brusselator, N, f64, dev)
    salg = sparse_alg(nls, fft_poisson_preconditioner, N)
    torch.cuda.synchronize()
    _backend.reset_counters()
    t0 = time.perf_counter()
    ssol = nls.solve(sprob, salg, abstol=1e-4, maxiters=30)
    torch.cuda.synchronize()
    sparse_first_s = time.perf_counter() - t0
    sparse_launches = dict(_backend.LAUNCHES)
    splan, = solve_mod._SPARSE_PLANS[sprob.f].values()
    s_resid = float(ssol.resid.abs().max())
    s_dist = (float((ssol.u.reshape(N, N, 2) - u64).abs().max())
              / max(float(u64.abs().max()), 1.0))
    rec = {"phase": "sparse_path", "N": N, "dtype": "float64",
           "retcode": ssol.retcode.name, "resid_inf": s_resid,
           "abstol": 1e-4, "stats": vars(ssol.stats),
           "krylov_iters": ssol.counters["krylov_iters"],
           "jac_products": ssol.counters["jvp"],
           "n_colors": splan.n_colors, "ndiag": splan.dia_plan.ndiag,
           "launches": sparse_launches,
           "host_syncs": ssol.counters["host_syncs"],
           "root_rel_inf_to_f64_polish": s_dist, "limit": 1e-3,
           "first_solve_s_with_plan": sparse_first_s}
    emit(rec)
    checks = {
        "retcode Success": ssol.retcode == nls.ReturnCode.Success,
        "|F|_inf <= 1e-4": s_resid <= 1e-4,
        "8 colors": splan.n_colors == 8,
        "11 diagonals": splan.dia_plan.ndiag == 11,
        "K5 selection launches == Jacobians":
            sparse_launches["gather_select"] == ssol.stats.njacs > 0,
        "K4 launches == Jacobian products":
            sparse_launches["dia_spmv"] == ssol.counters["jvp"] > 0,
        "no K1 launch": sparse_launches["brusselator_jvp"] == 0,
        "no CSR K5 launch": sparse_launches["gather_spmv"] == 0,
        "root within 1e-3 of the f64 polish": s_dist <= 1e-3,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"sparse path failed: {failed}")

    def warm_sparse():
        warm = nls.solve(sprob, salg, abstol=1e-4, maxiters=30)
        if warm.retcode != nls.ReturnCode.Success:
            raise AssertionError(f"warm sparse solve: {warm.retcode.name}")

    s_walls = warm_walls(torch, warm_sparse)
    emit({"phase": "sparse_path_timing", "warm_solve_s": s_walls,
          "warm_solve_s_median": sorted(s_walls)[1],
          **profile_device(torch, warm_sparse), "card": card})

    # the f32 variant at the flagship's abstol: reported, not required
    sprob32 = flat_problem(nls, brusselator, N, f32, dev)
    t0 = time.perf_counter()
    ssol32 = nls.solve(sprob32, salg, abstol=5.0, maxiters=30)
    torch.cuda.synchronize()
    emit({"phase": "sparse_path_f32", "retcode": ssol32.retcode.name,
          "resid_inf": float(ssol32.resid.abs().max()), "abstol": 5.0,
          "stats": vars(ssol32.stats),
          "krylov_iters": ssol32.counters["krylov_iters"],
          "seconds": time.perf_counter() - t0,
          "note": "the JAX package ends in MaxIters at |F|_inf 7.6 here"})
    del sprob32, ssol32

    # --- 7. CSR route: the permuted Brusselator, f64 N=512 -------------------
    perm = np.random.default_rng(42).permutation(n)
    pinv_t = torch.as_tensor(np.argsort(perm), device=dev)
    t0 = time.perf_counter()
    cprob = flat_problem(nls, brusselator, N, f64, dev, perm=perm)
    calg = sparse_alg(nls, fft_poisson_preconditioner, N, perm=perm,
                      dev=dev)
    torch.cuda.synchronize()
    _backend.reset_counters()
    csol = nls.solve(cprob, calg, abstol=1e-4, maxiters=30)
    torch.cuda.synchronize()
    csr_first_s = time.perf_counter() - t0
    csr_launches = dict(_backend.LAUNCHES)
    cplan, = solve_mod._SPARSE_PLANS[cprob.f].values()
    c_resid = float(csol.resid.abs().max())
    back = csol.u[pinv_t]
    c_dist = (float((back - ssol.u).abs().max())
              / max(float(ssol.u.abs().max()), 1.0))
    emit({"phase": "csr_route", "N": N, "dtype": "float64",
          "retcode": csol.retcode.name, "resid_inf": c_resid,
          "abstol": 1e-4, "stats": vars(csol.stats),
          "krylov_iters": csol.counters["krylov_iters"],
          "jac_products": csol.counters["jvp"], "nnz": cplan.pattern.nnz,
          "n_colors": cplan.n_colors, "tier": cplan.pattern.tier[0],
          "reordered": cplan.pattern.tier[2] is not None,
          "launches": csr_launches,
          "host_syncs": csol.counters["host_syncs"],
          "root_rel_inf_to_sparse_path": c_dist, "limit": 1e-8,
          "first_solve_s_with_plan": csr_first_s})
    checks = {
        "retcode Success": csol.retcode == nls.ReturnCode.Success,
        "|F|_inf <= 1e-4": c_resid <= 1e-4,
        "resident tier (K5)": (cplan.dia_plan is None
                               and cplan.pattern.tier[0] == "resident"),
        "K5 launches == Jacobian products":
            csr_launches["gather_spmv"] == csol.counters["jvp"] > 0,
        "K5 selection launches == Jacobians":
            csr_launches["gather_select"] == csol.stats.njacs > 0,
        "no K4 launch": csr_launches["dia_spmv"] == 0,
        "root within 1e-8 of the sparse path's":
            c_dist <= 1e-8,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"CSR route failed: {failed}")

    def warm_csr():
        warm = nls.solve(cprob, calg, abstol=1e-4, maxiters=30)
        if warm.retcode != nls.ReturnCode.Success:
            raise AssertionError(f"warm CSR solve: {warm.retcode.name}")

    c_walls = warm_walls(torch, warm_csr)
    emit({"phase": "csr_route_timing", "warm_solve_s": c_walls,
          "warm_solve_s_median": sorted(c_walls)[1],
          **profile_device(torch, warm_csr), "card": card})
    # K5 and its selection on this route's own tables, the Jacobian at the
    # root as data (outside the counted run)
    jac = cplan(lambda u: cprob.f.f(u, cprob.p), csol.u)
    csr_summary = csr_kernel_checks(torch, dev, spmv, cplan, jac.data)
    # phase 23 (c): K5's reverse rule on this route's matrix
    vjp_summary = {"gather_spmv": reverse_rule_check(
        torch, _backend, spmv, "gather_spmv", "csr_route_512_permuted",
        cplan.pattern, jac.data)}
    csr7 = jac              # phase 27 (c) applies it row-sharded
    del cprob, csol, back

    # --- 8. 3D kernels against their plain versions -------------------------
    rd3d_summary = rd3d_kernel_checks(torch, dev, stencil3d, column)

    # --- 9. 3D chain: the example's chained normalised matvec, 256³ f32 -----
    N3 = 256
    prob3 = reaction_diffusion.make_problem(N3, dtype=f32, kernel_jvp=True)
    u3, D3 = prob3.u0, prob3.p[0]
    chain3_steps = 200

    def chain3(steps):
        # examples/07_…:82-117: the absmax (clamped at 1) scales the next
        # step's output; the scale never leaves the device
        c = torch.ones_like(u3)
        s = torch.ones((), dtype=f32, device=dev)
        for _ in range(steps):
            c, m = stencil3d.rd3d_jvp_scaled(u3, c, D3, 1.0 / s, bz=8)
            s = torch.clamp(m, min=1.0)
        return c, s

    chain3(2)
    torch.cuda.synchronize()
    _backend.reset_counters()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    c3, s3 = chain3(chain3_steps)
    ev1.record()
    torch.cuda.synchronize()
    chain3_wall_ms = (time.perf_counter() - t0) * 1e3 / chain3_steps
    chain3_launches = dict(_backend.LAUNCHES)
    chain3_event_ms = ev0.elapsed_time(ev1) / chain3_steps
    chain3_ok = bool(torch.isfinite(c3).all()) and bool(torch.isfinite(s3))
    carry3 = {"c": torch.ones_like(u3),
              "s": torch.ones((), dtype=f32, device=dev)}

    def chain3_step():
        carry3["c"], m = stencil3d.rd3d_jvp_scaled(
            u3, carry3["c"], D3, 1.0 / carry3["s"], bz=8)
        carry3["s"] = torch.clamp(m, min=1.0)

    chain3_graph_ms = graph_time_ms(torch, chain3_step, calls=100, replays=4)
    # the example's own timing: chain-length slope between 10 and 110
    # steps, each chain ended by a scalar fetch
    chain3_slope_ms = 1e3 * profiling.slope_time(
        lambda: float(chain3(10)[0].abs().sum()),
        lambda: float(chain3(110)[0].abs().sum()), span=100, rounds=3)
    nnz3 = 8 * N3 ** 3
    rec = {"phase": "rd3d_chain", "N": N3, "dtype": "float32", "bz": 8,
           "steps": chain3_steps, "launches": chain3_launches,
           "finite": chain3_ok, "final_scale": float(s3),
           "step_ms_wall": chain3_wall_ms, "step_ms_events": chain3_event_ms,
           "step_ms_graph": chain3_graph_ms, "step_ms_slope": chain3_slope_ms,
           "nnz_per_step": nnz3,
           "tnnz_per_s_graph": nnz3 / chain3_graph_ms / 1e9,
           "tnnz_per_s_events": nnz3 / chain3_event_ms / 1e9,
           "tnnz_per_s_slope": nnz3 / max(chain3_slope_ms, 1e-9) / 1e9,
           "card": card}
    emit(rec)
    checks = {
        "K10 launches == chain steps":
            chain3_launches["rd3d_jvp_scaled"] == chain3_steps,
        "no K9 launch": chain3_launches["rd3d_jvp"] == 0,
        "chain finite": chain3_ok,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"3D chain failed: {failed}")
    del c3, carry3

    # --- 10. 3D solve at the example's operating point, 256³ f32 ------------
    pm3 = fft_poisson_preconditioner((N3, N3, N3), 0.01, 1.0 / N3,
                                     shift=-0.9)
    alg3 = nls.NewtonRaphson(
        linsolve=nls.LinearSolver(method="gmres", restart=8,
                                  krylov_maxiter=200, precond_fn=pm3),
        forcing=nls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))
    abstol3 = 1e-5 * N3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _backend.reset_counters()
    t0 = time.perf_counter()
    sol3 = nls.solve(prob3, alg3, abstol=abstol3, maxiters=30)
    torch.cuda.synchronize()
    solve3_first_s = time.perf_counter() - t0
    launches3 = dict(_backend.LAUNCHES)
    resid3 = float(sol3.resid.abs().max())
    jax_stats = {"nsteps": 6, "nf": 8, "njacs": 6}
    stats3 = {k: getattr(sol3.stats, k) for k in jax_stats}
    emit({"phase": "rd3d_solve", "N": N3, "dtype": "float32",
          "retcode": sol3.retcode.name, "resid_inf": resid3,
          "abstol": abstol3, "stats": vars(sol3.stats),
          "stats_jax_cpu": jax_stats, "stats_equal_jax": stats3 == jax_stats,
          "krylov_iters": sol3.counters["krylov_iters"],
          "jac_products": sol3.counters["jvp"], "launches": launches3,
          "host_syncs": sol3.counters["host_syncs"],
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "first_solve_s": solve3_first_s})
    checks = {
        "retcode Success": sol3.retcode == nls.ReturnCode.Success,
        "|F|_inf <= 1e-5 N": resid3 <= abstol3,
        "K9 launches == Jacobian products":
            launches3["rd3d_jvp"] == sol3.counters["jvp"] > 0,
        "no K1, K2, K4, K5 or K10 launch": not any(
            launches3[k] for k in ("brusselator_jvp",
                                   "brusselator_jvp_scaled", "dia_spmv",
                                   "gather_spmv", "gather_select",
                                   "rd3d_jvp_scaled")),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"3D solve failed: {failed}")

    def warm_rd3d():
        warm = nls.solve(prob3, alg3, abstol=abstol3, maxiters=30)
        if warm.retcode != nls.ReturnCode.Success:
            raise AssertionError(f"warm 3D solve: {warm.retcode.name}")

    r_walls = warm_walls(torch, warm_rd3d)
    r_prof = profile_device(torch, warm_rd3d)
    chained3_s = profiling.chained_solve_time(prob3, alg3, k=3, reps=3,
                                              abstol=abstol3, maxiters=30)
    emit({"phase": "rd3d_solve_timing", "warm_solve_s": r_walls,
          "warm_solve_s_median": sorted(r_walls)[1], **r_prof,
          "chained_solve_s": chained3_s,
          "mdof_per_s_chained": N3 ** 3 / max(chained3_s, 1e-9) / 1e6,
          "card": card})

    rd3d_ref = (sol3.u.clone(), sol3.stats.nsteps)     # for phase 27 (d)

    # --- 11. 3D f64 polish on the card ---------------------------------------
    prob3_64 = reaction_diffusion.make_problem(
        N3, dtype=torch.float64, kernel_jvp=True).remake(u0=sol3.u.double())
    pm3_64 = fft_poisson_preconditioner((N3, N3, N3), 0.01, 1.0 / N3,
                                        shift=-0.9)
    alg3_64 = nls.NewtonRaphson(
        linsolve=nls.LinearSolver(method="gmres", restart=16,
                                  krylov_maxiter=200, precond_fn=pm3_64),
        forcing=nls.EisenstatWalkerForcing(eta_0=1e-4, eta_max=1e-4))
    torch.cuda.synchronize()
    _backend.reset_counters()
    t0 = time.perf_counter()
    sol3_64 = nls.solve(prob3_64, alg3_64, abstol=1e-10, maxiters=10)
    torch.cuda.synchronize()
    polish3_s = time.perf_counter() - t0
    polish3_launches = dict(_backend.LAUNCHES)
    u3_64 = sol3_64.u
    dist3 = (float((sol3.u.double() - u3_64).abs().max())
             / max(float(u3_64.abs().max()), 1.0))
    emit({"phase": "rd3d_f64_polish", "retcode": sol3_64.retcode.name,
          "stats": vars(sol3_64.stats),
          "krylov_iters": sol3_64.counters["krylov_iters"],
          "resid_inf": float(sol3_64.resid.abs().max()), "abstol": 1e-10,
          "launches": polish3_launches,
          "f32_root_rel_inf_distance": dist3, "limit": 1e-4,
          "seconds": polish3_s})
    if (sol3_64.retcode != nls.ReturnCode.Success or not dist3 <= 1e-4
            or polish3_launches["rd3d_jvp"] != sol3_64.counters["jvp"]):
        raise AssertionError(f"3D f64 polish: {sol3_64.retcode.name}, "
                             f"distance {dist3}, launches "
                             f"{polish3_launches}")
    del prob3_64, sol3_64

    # --- 12. band route: the 3D steady state on the assembled sparse path ---
    from nonlinearsolve_tpu_torch.ops import spmv_scatter, spmv_stream
    from nonlinearsolve_tpu_torch.ops.coloring import greedy_column_coloring
    from nonlinearsolve_tpu_torch.ops.sparse import CSR
    n3 = N3 ** 3
    spmv.clear_plan_caches()
    t0 = time.perf_counter()
    pat3 = periodic7_pattern(CSR, N3)
    t_pattern3 = time.perf_counter() - t0
    t0 = time.perf_counter()
    colors3 = greedy_column_coloring(pat3)
    t_coloring3 = time.perf_counter() - t0
    t0 = time.perf_counter()
    bplan3 = spmv_stream.band_plan_for(pat3.indptr, pat3.indices, n3, n3)
    t_band3 = time.perf_counter() - t0
    t0 = time.perf_counter()
    tier3 = pat3.tier
    t_tier3 = time.perf_counter() - t0
    t0 = time.perf_counter()
    bplan3.sel.table(dev)
    bplan3.cols_table(dev)
    torch.cuda.synchronize()
    t_tables3 = time.perf_counter() - t0
    per_nnz3 = (spmv._derated_cost("stream", bplan3) * (bplan3.n_pad / 128)
                / pat3.nnz)
    emit({"phase": "band_route_plan", "N": N3, "nnz": pat3.nnz,
          "pattern_s": t_pattern3, "coloring_s": t_coloring3,
          "band_plan_s": t_band3,
          "tier_selection_s_besides_band_plan": t_tier3,
          "pack_tables_s": t_tables3,
          "host_plan_s": (t_pattern3 + t_coloring3 + t_band3 + t_tier3
                          + t_tables3),
          "n_colors": int(colors3.max()) + 1, "tier": tier3[0],
          "reordered": tier3[2] is not None, "w": bplan3.w,
          "bands": bplan3.bands, "F": bplan3.F,
          "group_lo_t": bplan3.group_lo_t, "cost_per_nnz": per_nnz3})
    checks = {
        "tier stream": tier3[0] == "stream" and tier3[1] is bplan3,
        "no reorder": tier3[2] is None,
        "w 11, 5 bands": (bplan3.w, len(bplan3.bands)) == (11, 5),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"band route plan: {failed}")

    bprob = flat3d_problem(nls, reaction_diffusion, N3, f32, dev, pat3,
                           colorvec=colors3)
    balg = sparse_alg3d(nls, fft_poisson_preconditioner, N3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _backend.reset_counters()
    t0 = time.perf_counter()
    bsol = nls.solve(bprob, balg, abstol=abstol3, maxiters=30)
    torch.cuda.synchronize()
    band_first_s = time.perf_counter() - t0
    b_launches = dict(_backend.LAUNCHES)
    bcj, = solve_mod._SPARSE_PLANS[bprob.f].values()
    b_resid = float(bsol.resid.abs().max())
    b_dist = (float((bsol.u.double() - u3_64.reshape(-1)).abs().max())
              / max(float(u3_64.abs().max()), 1.0))
    emit({"phase": "band_route", "N": N3, "dtype": "float32",
          "retcode": bsol.retcode.name, "resid_inf": b_resid,
          "abstol": abstol3, "stats": vars(bsol.stats),
          "nsteps_matrix_free": sol3.stats.nsteps,
          "krylov_iters": bsol.counters["krylov_iters"],
          "jac_products": bsol.counters["jvp"], "n_colors": bcj.n_colors,
          "tier": bcj.pattern.tier[0], "launches": b_launches,
          "host_syncs": bsol.counters["host_syncs"],
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "root_rel_inf_to_f64_polish": b_dist, "limit": 1e-4,
          "first_solve_s_with_plan": band_first_s})
    checks = {
        "retcode Success": bsol.retcode == nls.ReturnCode.Success,
        "|F|_inf <= 1e-5 N": b_resid <= abstol3,
        "nsteps within 1 of the matrix-free solve's":
            abs(bsol.stats.nsteps - sol3.stats.nsteps) <= 1,
        "K7 launches == Jacobian products":
            b_launches["band_spmv"] == bsol.counters["jvp"] > 0,
        "selection launches == 2 x Jacobians":
            b_launches["gather_select"] == 2 * bsol.stats.njacs > 0,
        "no K4, CSR K5, K8 or K9 launch": not any(
            b_launches[k] for k in ("dia_spmv", "gather_spmv",
                                    "scatter_spmv_part", "rd3d_jvp",
                                    "rd3d_jvp_scaled")),
        "root within 1e-4 of the f64 polish": b_dist <= 1e-4,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"band route failed: {failed}")

    def warm_band():
        warm = nls.solve(bprob, balg, abstol=abstol3, maxiters=30)
        if warm.retcode != nls.ReturnCode.Success:
            raise AssertionError(f"warm band-route solve: "
                                 f"{warm.retcode.name}")

    torch.cuda.reset_peak_memory_stats()
    b_walls = warm_walls(torch, warm_band)
    emit({"phase": "band_route_timing", "warm_solve_s": b_walls,
          "warm_solve_s_median": sorted(b_walls)[1],
          **profile_device(torch, warm_band),
          "peak_memory_gib_warm": torch.cuda.max_memory_allocated() / 2 ** 30,
          "card": card})
    # K7 (and K5 on the same matrix) on this route's own tables, the
    # Jacobian at the root as data (outside the counted run)
    jac3 = bcj(lambda u: bprob.f.f(u, bprob.p), bsol.u)
    band_summary = band_kernel_checks(torch, dev, spmv, spmv_stream, pat3,
                                      bplan3, jac3.data)
    # phase 23 (c): K7's reverse rule on this route's matrix and plan
    vjp_summary["band_spmv"] = reverse_rule_check(
        torch, _backend, spmv, "band_spmv", "band_route_256", pat3,
        jac3.data)
    del jac3, bprob, bsol, bcj, u3_64, sol3, prob3
    spmv.clear_plan_caches()
    del pat3, bplan3, tier3

    # --- 13. scatter route: the 3D steady state, unknowns permuted, 96³ ---
    N96 = 96
    n96 = N96 ** 3
    abstol96 = 1e-5 * N96
    perm96 = np.random.default_rng(42).permutation(n96)
    pinv96_t = torch.as_tensor(np.argsort(perm96), device=dev)
    t0 = time.perf_counter()
    spat = periodic7_pattern(CSR, N96, perm96)
    t_pattern96 = time.perf_counter() - t0
    t0 = time.perf_counter()
    scolors = greedy_column_coloring(spat)
    t_coloring96 = time.perf_counter() - t0
    t0 = time.perf_counter()
    stier = spat.tier
    t_tier96 = time.perf_counter() - t0
    if stier[0] != "scatter":
        raise AssertionError(f"scatter route plan: tier {stier[0]}")
    splan96 = stier[1]
    t0 = time.perf_counter()
    splan96.sel.table(dev)
    splan96.tables(dev)
    torch.cuda.synchronize()
    t_tables96 = time.perf_counter() - t0
    parts96 = [(c0, c1, part.B, part.P, len(part.r_plans))
               for (c0, c1, _sel, part) in splan96.parts]
    emit({"phase": "scatter_route_plan", "N": N96, "nnz": spat.nnz,
          "pattern_s": t_pattern96, "coloring_s": t_coloring96,
          "tier_selection_s": t_tier96, "stage_tables_s": t_tables96,
          "host_plan_s": (t_pattern96 + t_coloring96 + t_tier96
                          + t_tables96),
          "n_colors": int(scolors.max()) + 1, "tier": stier[0],
          "reordered": stier[2] is not None,
          "parts_c0_c1_B_P_chain": parts96,
          "cost_per_nnz": spmv.spmv_tier_cost("scatter", splan96)
          * (splan96.n_pad / 128) / spat.nnz})
    chain96 = sum(p[4] for p in parts96)
    checks = {
        "no reorder": stier[2] is None,
        "3 parts, one R plan each": len(parts96) == 3 and chain96 == 3,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"scatter route plan: {failed}")

    # the same problem in natural order (the DIA tier: K4), the reference
    nprob = flat3d_problem(nls, reaction_diffusion, N96, f32, dev,
                           periodic7_pattern(CSR, N96))
    nsol = nls.solve(nprob, sparse_alg3d(nls, fft_poisson_preconditioner,
                                         N96), abstol=abstol96, maxiters=30)
    ncj, = solve_mod._SPARSE_PLANS[nprob.f].values()
    if nsol.retcode != nls.ReturnCode.Success or ncj.dia_plan is None:
        raise AssertionError(f"natural-order 96³ solve: {nsol.retcode.name}, "
                             f"tier {ncj.pattern.tier[0]}")

    sprob96 = flat3d_problem(nls, reaction_diffusion, N96, f32, dev, spat,
                             perm=perm96, colorvec=scolors)
    salg96 = sparse_alg3d(nls, fft_poisson_preconditioner, N96, perm=perm96,
                          dev=dev)
    torch.cuda.synchronize()
    _backend.reset_counters()
    t0 = time.perf_counter()
    ssol96 = nls.solve(sprob96, salg96, abstol=abstol96, maxiters=30)
    torch.cuda.synchronize()
    scatter_first_s = time.perf_counter() - t0
    s_launches = dict(_backend.LAUNCHES)
    scj, = solve_mod._SPARSE_PLANS[sprob96.f].values()
    s96_resid = float(ssol96.resid.abs().max())
    s96_dist = (float((ssol96.u[pinv96_t] - nsol.u).abs().max())
                / max(float(nsol.u.abs().max()), 1.0))
    products96 = ssol96.counters["jvp"]
    emit({"phase": "scatter_route", "N": N96, "dtype": "float32",
          "retcode": ssol96.retcode.name, "resid_inf": s96_resid,
          "abstol": abstol96, "stats": vars(ssol96.stats),
          "natural_order_stats": vars(nsol.stats),
          "krylov_iters": ssol96.counters["krylov_iters"],
          "jac_products": products96, "n_colors": scj.n_colors,
          "tier": scj.pattern.tier[0], "launches": s_launches,
          "host_syncs": ssol96.counters["host_syncs"],
          "root_rel_inf_to_natural_order": s96_dist, "limit": 1e-4,
          "first_solve_s_with_plan": scatter_first_s})
    checks = {
        "retcode Success": ssol96.retcode == nls.ReturnCode.Success,
        "|F|_inf <= 1e-5 N": s96_resid <= abstol96,
        "K8 launches == 3 parts x products":
            s_launches["scatter_spmv_part"] == 3 * products96 > 0,
        "selection launches == 2 x Jacobians":
            s_launches["gather_select"] == 2 * ssol96.stats.njacs > 0,
        "no K4, CSR K5, K7 or K9 launch": not any(
            s_launches[k] for k in ("dia_spmv", "gather_spmv", "band_spmv",
                                    "rd3d_jvp", "rd3d_jvp_scaled")),
        "root within 1e-4 of the natural order's": s96_dist <= 1e-4,
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"scatter route failed: {failed}")

    def warm_scatter():
        warm = nls.solve(sprob96, salg96, abstol=abstol96, maxiters=30)
        if warm.retcode != nls.ReturnCode.Success:
            raise AssertionError(f"warm scatter-route solve: "
                                 f"{warm.retcode.name}")

    s96_walls = warm_walls(torch, warm_scatter)
    emit({"phase": "scatter_route_timing", "warm_solve_s": s96_walls,
          "warm_solve_s_median": sorted(s96_walls)[1],
          **profile_device(torch, warm_scatter), "card": card})
    jac96 = scj(lambda u: sprob96.f.f(u, sprob96.p), ssol96.u)
    scatter_summary = scatter_kernel_checks(torch, dev, spmv, spmv_scatter,
                                            spat, splan96, jac96.data)
    # phase 23 (c): K8's reverse rule on this route's matrix and plan
    vjp_summary["scatter_spmv_part"] = reverse_rule_check(
        torch, _backend, spmv, "scatter_spmv_part",
        "scatter_route_96_permuted", spat, jac96.data)
    del jac96, sprob96, ssol96, nprob, nsol

    # --- 14. the bf16 path: the flagship with the bf16 basis (and K3) -------
    def bf16_alg():
        return nls.NewtonRaphson(
            linsolve=nls.LinearSolver(method="gmres", restart=8,
                                      krylov_maxiter=100, precond_fn=pm,
                                      krylov_basis_dtype="bf16"),
            forcing=nls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))

    # docs/solvers.md's mixed-precision problem: K3 as the analytic jvp
    prob_k3 = nls.NonlinearProblem(
        nls.NonlinearFunction(
            f=brusselator.brusselator_2d,
            jvp=lambda v, U, p_: stencil.make_brusselator_jvp_bf16(U, p_)(v)),
        prob.u0, prob.p)
    bf16_launches = {}
    for run, bprob in (("a", prob), ("b", prob_k3)):
        expected = JAX_BF16_FLAGSHIP[run]
        balg16 = bf16_alg()
        torch.cuda.synchronize()
        _backend.reset_counters()
        t0 = time.perf_counter()
        bsol16 = nls.solve(bprob, balg16, abstol=5.0, maxiters=30)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        bl = dict(_backend.LAUNCHES)
        bf16_launches[run] = bl
        b_resid16 = float(bsol16.resid.abs().max())
        b_dist16 = (float((bsol16.u.double() - u64).abs().max())
                    / max(float(u64.abs().max()), 1.0))

        def warm_bf16(bprob=bprob, balg16=balg16):
            nls.solve(bprob, balg16, abstol=5.0, maxiters=30)

        walls16 = warm_walls(torch, warm_bf16)
        success = bsol16.retcode == nls.ReturnCode.Success
        rec = {"phase": f"bf16_flagship_{run}", "N": N, "dtype": "float32",
               "krylov_basis_dtype": "bf16",
               "matvec": "K3 (bf16)" if run == "b" else "K1 (f32)",
               "retcode": bsol16.retcode.name, "resid_inf": b_resid16,
               "abstol": 5.0, "stats": vars(bsol16.stats),
               "expected_jax_cpu": expected,
               "krylov_iters": bsol16.counters["krylov_iters"],
               "jac_products": bsol16.counters["jvp"], "launches": bl,
               "host_syncs": bsol16.counters["host_syncs"],
               "root_rel_inf_to_f64_polish": b_dist16,
               "u_equals_u0": torch.equal(bsol16.u.reshape(-1),
                                          bprob.u0.reshape(-1)),
               "flagship_nsteps": sol.stats.nsteps,
               "success_within_1_step_of_flagship": bool(
                   success and abs(bsol16.stats.nsteps
                                   - sol.stats.nsteps) <= 1),
               "first_solve_s": first_s, "warm_solve_s": walls16,
               "warm_ms_per_krylov_iter": 1e3 * sorted(walls16)[1]
               / max(bsol16.counters["krylov_iters"], 1), "card": card}
        emit(rec)
        used, unused = (("brusselator_jvp_bf16", "brusselator_jvp")
                        if run == "b" else
                        ("brusselator_jvp", "brusselator_jvp_bf16"))
        checks = {
            "retcode as the JAX package's":
                bsol16.retcode.name == expected["retcode"],
            "nsteps within 2 of the JAX package's":
                abs(bsol16.stats.nsteps - expected["nsteps"]) <= 2,
            "nf as the JAX package's": bsol16.stats.nf == expected["nf"],
            f"{used} launches == Jacobian products":
                bl[used] == bsol16.counters["jvp"] > 0,
            f"no {unused} launch": bl[unused] == 0,
        }
        if success or run == "a":
            checks["root within 1e-2 of the f64 polish"] = b_dist16 <= 1e-2
        if run == "a":
            checks[f"|F|_inf <= {BF16_A_RESID_INF_MAX}"] = (
                b_resid16 <= BF16_A_RESID_INF_MAX)
        else:
            checks["|F|_inf within rel 1e-6 of the JAX package's"] = (
                abs(b_resid16 - expected["resid_inf"])
                <= 1e-6 * expected["resid_inf"])
            checks["u == u0 bit for bit, as in the JAX package"] = (
                torch.equal(bsol16.u.reshape(-1), bprob.u0.reshape(-1)))
        failed = [k for k, v in checks.items() if not v]
        if failed:
            raise AssertionError(f"bf16 flagship run ({run}) failed: {failed}")
        del bsol16

    # the basis alone: 8 Arnoldi iterations at u0 (rtol 0), f32 and bf16,
    # the walls in turns, then one profiled call each
    from nonlinearsolve_tpu_torch.ops.krylov import gmres
    fu0 = brusselator.brusselator_2d(prob.u0, prob.p)

    def one_gmres(bdt):
        r = gmres(lambda v: stencil.brusselator_jvp(prob.u0, v, prob.p),
                  fu0, restart=8, maxiter=8, rtol=0.0, M=pm, basis_dtype=bdt)
        if r.iterations != 8:
            raise AssertionError(f"GMRES ran {r.iterations} iterations")

    basis_dtypes = {"f32": None, "bf16": torch.bfloat16}
    basis_walls = {name: [] for name in basis_dtypes}
    for _ in range(5):
        for name, bdt in basis_dtypes.items():
            basis_walls[name] += warm_walls(torch, lambda: one_gmres(bdt),
                                            count=1)
    basis_rec = {"phase": "bf16_basis_gmres", "N": N, "iterations": 8,
                 "card": card}
    for name, bdt in basis_dtypes.items():
        prof_g = profile_device(torch, lambda: one_gmres(bdt))
        basis_rec[name] = {"wall_ms": [1e3 * w for w in basis_walls[name]],
                           "wall_ms_median":
                               1e3 * sorted(basis_walls[name])[2],
                           "device_busy_ms": prof_g["device_busy_ms"],
                           "device_ms_by_group":
                               prof_g["device_ms_by_group"]}
    emit(basis_rec)

    # --- 15. K11 on z-slabs against K9 on the whole grid ---------------------
    k11_summary = k11_kernel_checks(torch, dev, stencil3d, column)

    # --- 16. the distributed entry point: NCCL at world size 1, 256³ --------
    import torch.distributed as dist
    from nonlinearsolve_tpu_torch.parallel.scaling import weak_scaling_report
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        torch.cuda.synchronize()
        _backend.reset_counters()
        t0 = time.perf_counter()
        ws_rows = weak_scaling_report([1], base_n=256, n_matvecs=50,
                                      use_pallas=True, bz=8)
        torch.cuda.synchronize()
        ws_wall = time.perf_counter() - t0
        ws_launches = dict(_backend.LAUNCHES)
    finally:
        dist.destroy_process_group()
    ws_rate = ws_rows[0][1] if ws_rows else float("nan")
    emit({"phase": "weak_scaling", "backend": "nccl", "world_size": 1,
          "base_n": 256, "n_matvecs": 50, "use_pallas": True, "bz": 8,
          "rows": ws_rows, "nnz_per_s": ws_rate,
          "step_ms": 1e3 * 7 * N3 ** 3 / ws_rate,
          "k10_chain_step_ms_graph": chain3_graph_ms,
          "k10_chain_tnnz_per_s_graph": nnz3 / chain3_graph_ms / 1e9,
          "launches": ws_launches, "seconds": ws_wall, "card": card,
          "note": "7 nnz a point, as the JAX report counts; the K10 chain "
                  "of phase 9 counts 8"})
    checks = {
        "one row, efficiency 1": (len(ws_rows) == 1 and ws_rows[0][0] == 1
                                  and ws_rows[0][2] == 1.0),
        "rate finite and > 0": math.isfinite(ws_rate) and ws_rate > 0,
        "K11 launches == 2 x 50 (the warm-up chain and the timed one)":
            ws_launches["rd3d_jvp_halo"] == 2 * 50,
        "no K9 or K10 launch": not (ws_launches["rd3d_jvp"]
                                    or ws_launches["rd3d_jvp_scaled"]),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"weak scaling failed: {failed}")

    # --- 17. the block-sparse layer: phase 6's Jacobian at the root as BSR --
    from nonlinearsolve_tpu_torch.ops.preconditioners import (
        block_jacobi_preconditioner)
    from nonlinearsolve_tpu_torch.ops.sparse import BSR

    def sres(u):
        return sprob.f.f(u, sprob.p)

    # outside the counted run: J assembled once with the plan as CSR (K5's
    # selection), the compressed JVPs, and J·x on J's own tier (K4)
    t_phase = time.perf_counter()
    J = splan(sres, ssol.u)
    compressed = splan._compressed(sres, ssol.u)
    S = torch.as_tensor(splan._seeds.T.copy(), dtype=f64, device=dev)
    brng = np.random.default_rng(7)
    xb = torch.as_tensor(brng.standard_normal(n), device=dev)
    vb = torch.as_tensor(brng.standard_normal(n), device=dev)
    y_csr = J.matvec(xb)
    torch.cuda.synchronize()
    _backend.reset_counters()
    t0 = time.perf_counter()
    Jb = BSR.from_csr(J, 2)
    t_from_csr = time.perf_counter() - t0
    Y = spmv.bsr_spmm(Jb, S)
    k6_products = 1
    y_bsr = Jb.matvec(xb)
    D = Jb.diag_blocks()
    v_back = block_jacobi_preconditioner(D)(
        torch.bmm(D, vb.reshape(-1, 2, 1)).reshape(-1))
    torch.cuda.synchronize()
    bsr_s = time.perf_counter() - t0
    bsr_launches = dict(_backend.LAUNCHES)
    seeds_equal = bool(torch.equal(Y, compressed.t()))
    mv_err = rel_err(y_bsr, y_csr)
    bj_err = rel_err(v_back, vb)
    per_row = np.diff(Jb.indptr)
    emit({"phase": "block_sparse", "N": N, "dtype": "float64",
          "blocksize": 2, "block_rows": len(per_row),
          "nblocks": len(Jb.indices), "blocks_per_row": [
              int(per_row.min()), int(per_row.max())],
          "diag_blocks_shape": list(D.shape),
          "seeds_product_equals_compressed_jvps": seeds_equal,
          "matvec_rel_err_to_csr": mv_err[1],
          "block_jacobi_rel_err": bj_err[1], "tolerance": TOL["float64"],
          "launches": bsr_launches, "k6_products": k6_products,
          "from_csr_s": t_from_csr, "seconds": bsr_s})
    nbr = n // 2
    checks = {
        "1,310,720 blocks, 5 a block row": (len(Jb.indices) == 5 * nbr
                                           and bool((per_row == 5).all())),
        "diag_blocks (262144, 2, 2)": tuple(D.shape) == (nbr, 2, 2),
        "K6 x seeds == compressed JVPs, bit for bit": seeds_equal,
        "BSR.matvec (K5) == CSR J·x at TOL": mv_err[1] <= TOL["float64"],
        "block-Jacobi gives v back at TOL": bj_err[1] <= TOL["float64"],
        "K6 launches == products": bsr_launches["bsr_spmm"] == k6_products,
        "one K5 launch (the matvec)": bsr_launches["gather_spmv"] == 1,
        "no K4, K7 or K8 launch": not any(
            bsr_launches[k] for k in ("dia_spmv", "band_spmv",
                                      "scatter_spmv_part")),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"block-sparse layer failed: {failed}")
    bsr_summary = bsr_kernel_checks(torch, dev, spmv, Jb)
    emit({"phase": "block_sparse_timing",
          "phase_seconds": time.perf_counter() - t_phase, "card": card})
    del J, compressed, S, Y, Jb, D

    # --- 18. the dense Brusselator (the tutorial's dense rung) -------------
    nr_root = dense_brusselator_phase(torch, nls, _backend, brusselator,
                                      fft_poisson_preconditioner, card)

    # --- 19. the 23-problem suite and the NLLS classics --------------------
    problems23_phase(torch, nls, _backend, card)

    # --- 20. the quasi-Newton, spectral and polyalgorithm engines ----------
    qn_polyalg_phase(torch, nls, _backend, brusselator, nr_root, card)
    del nr_root

    # --- 21. the sparse direct route (Bratu, SNES ex2) ----------------------
    sd_launches, lu_stage_rec, lu_big_rec, sd_checks = sparse_direct_phase(
        torch, nls, _backend, spmv, card)

    # --- 22. the batched tier (simple solvers, bracketing, ensembles) -------
    batched_tier_phase(torch, nls, _backend, card)

    # --- 23. differentiating through solve, and the A.18 surface ---------
    sens_rec = sensitivity_phase(torch, nls, _backend, brusselator, stencil,
                                 spmv, card, prob, alg, prob64, alg64)

    # --- 24. continuation, steady states, SCC, user algorithms, SciPy ------
    continuation_phase(torch, nls, _backend, card, prob, alg)

    # --- 25. pytree, 0-d and complex states, the polynomial drivers -------
    a33_phase(torch, nls, _backend, brusselator, fft_poisson_preconditioner,
              card)

    # --- 26. complex ordering, sparsity detection, refinement -------------
    s17 = slice17_phase(torch, nls, _backend, brusselator, stencil,
                        fft_poisson_preconditioner, card, sol, pm, u64, ssol)
    del ssol

    # --- 27. multigrid, the spectral factories, the sharded layer ---------
    k5_sharded = slice18_phase(torch, nls, _backend, brusselator, spmv,
                               fft_poisson_preconditioner, card, u64, csr7,
                               rd3d_ref)
    del csr7, rd3d_ref

    # --- 28. lockstep first-order ensembles, the AOT round trip -----------
    lockstep_phase(torch, nls, _backend, brusselator, card)

    # --- 29. summary -------------------------------------------------------
    out = []
    timing_keys = ("ms", "plain_ms", "bound_ms", "share_of_bound")
    for name in ("brusselator_jvp", "brusselator_jvp_scaled"):
        r = summary[(name, 512)]
        row = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": None,
               "library_note": LIBRARY_NOTE,
               "share_of_bound": r["share_of_bound"],
               "shape": [N, N, 2], "dtype": "float32",
               "note": "operands of 6 MiB are L2-resident at N=512",
               "N2048": {k: summary[(name, 2048)][k] for k in timing_keys}}
        if name == "brusselator_jvp":
            row["launches_refinement"] = s17["refinement"].get(name, 0)
        if name == "brusselator_jvp_scaled":
            row["chain_step_ms_graph"] = chain_graph_ms
            row["kernels_per_wrapper_call"] = timings[
                ("brusselator_jvp_scaled", 512, "float32")]["launches_per_call"]
            row["tensor_inv_scale_ms"] = timings[
                ("brusselator_jvp_scaled_tensor_inv", 512, "float32")]["ms"]
            row["planar"] = {
                f"N{n}": {k: summary[("brusselator_jvp_scaled_pair", n)][k]
                          for k in timing_keys} for n in (512, 2048)}
        out.append(row)
    path_launches = {"dia_spmv": sparse_launches["dia_spmv"],
                     "gather_select": sparse_launches["gather_select"],
                     "gather_spmv": csr_launches["gather_spmv"]}
    spmv_summary["gather_spmv"] = csr_summary["gather_spmv"]
    for name in ("dia_spmv", "gather_spmv", "gather_select"):
        r = spmv_summary[name]
        out.append({"name": name, "route": "cuda", "source": SPMV_SOURCE,
                    "replaces": SPMV_REPLACES[name],
                    "launches": path_launches[name],
                    "launches_in": ("csr_route" if name == "gather_spmv"
                                    else "sparse_path"),
                    "tables": r["tables"],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"],
                    "library_note": r["library"],
                    "share_of_bound": r["share_of_bound"],
                    "shape": r["shape"], "dtype": "float64"})
        if name != "gather_spmv":
            out[-1]["launches_detected_pattern"] = s17[
                "detected_sparse_path"].get(name, 0)
    k5_row = next(o for o in out if o["name"] == "gather_spmv")
    k5_row["index_select_ms"] = spmv_summary["gather_spmv"]["index_select_ms"]
    k5_row["sharded_matvec"] = k5_sharded
    k5_row["other_tables"] = {
        rec["tables"] + "_" + rec["dtype"]: {
            k: rec[k] for k in ("ms", "plain_ms", "bound_ms",
                                "share_of_bound", "library_ms",
                                "index_select_ms", "max_abs_err")}
        for rec in (scatter_summary[("gather_spmv", "float32")],
                    band_summary["gather_spmv_same_tables"])}
    # phase 21: the launches of each sparse direct run (K4 in BiCGStab and
    # GMRES, K5 on the device LU's gathers, its selection in every
    # assembly), and K5 on the 128² device-LU plan's gathers
    for row in out:
        if row["name"] in ("dia_spmv", "gather_spmv", "gather_select"):
            row["launches_sparse_direct"] = {
                key: counts.get(row["name"], 0)
                for key, counts in sd_launches.items()}
        if row["name"] in sd_checks:
            row["checks_sparse_direct"] = sd_checks[row["name"]]
    k5_row["device_lu_128_per_solve"] = {
        k: lu_stage_rec[k] for k in (
            "gathers", "ell_stages", "launches_per_solve", "nnz_per_solve",
            "ms_per_solve", "ms_profiled_per_solve", "plain_ms_per_solve",
            "library_ms_per_solve",
            "bound_ms_per_solve", "bound_by", "bound_bytes",
            "share_of_bound", "max_rel_err")}
    k5_row["device_lu_128_largest_ell_stage"] = {
        k: lu_big_rec[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                   "share_of_bound", "library_ms",
                                   "max_abs_err")}
    r = band_summary["band_spmv"]
    out.append({"name": "band_spmv", "route": "cuda", "source": SPMV_SOURCE,
                "replaces": SPMV_REPLACES["band_spmv"],
                "launches": b_launches["band_spmv"],
                "launches_in": "band_route", "tables": r["tables"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "library_note": r["library"],
                "share_of_bound": r["share_of_bound"], "shape": r["shape"],
                "dtype": "float32"})
    r = scatter_summary[("scatter_spmv_part", "float32")]
    r64 = scatter_summary[("scatter_spmv_part", "float64")]
    out.append({"name": "scatter_spmv_part", "route": "cuda",
                "source": SPMV_SOURCE,
                "replaces": SPMV_REPLACES["scatter_spmv_part"],
                "launches": s_launches["scatter_spmv_part"],
                "launches_in": "scatter_route", "tables": r["tables"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "library_note": r["library"],
                "share_of_bound": r["share_of_bound"], "shape": r["shape"],
                "dtype": "float32",
                "note": "ms, bound and library for the whole product: one "
                        "launch a part, 3 parts",
                "index_select_ms": r["index_select_ms"],
                "float64": {k: r64[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "share_of_bound", "library_ms", "index_select_ms")}})
    for name, path_launches_3d, where in (
            ("rd3d_jvp", launches3["rd3d_jvp"], "rd3d_solve"),
            ("rd3d_jvp_scaled", chain3_launches["rd3d_jvp_scaled"],
             "rd3d_chain")):
        r = rd3d_summary[name]
        out.append({"name": name, "route": "cuda", "source": SOURCE_3D,
                    "replaces": REPLACES[name], "launches": path_launches_3d,
                    "launches_in": where, "max_abs_err": r["max_abs_err"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                    "library_ms": None, "library_note": LIBRARY_NOTE,
                    "share_of_bound": r["share_of_bound"],
                    "shape": r["shape"], "dtype": "float32",
                    "config": r["config"]})
    r = k3_summary[512]
    mv_keys = ("ms", "bound_ms", "share_of_bound", "mv_ms", "mv_bound_ms",
               "mv_share_of_bound", "k1_f32_ms")
    out.append({"name": "brusselator_jvp_bf16", "route": "cuda",
                "source": SOURCE, "replaces": REPLACES["brusselator_jvp_bf16"],
                "launches": bf16_launches["b"]["brusselator_jvp_bf16"],
                "launches_in": "bf16_flagship_b",
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None,
                "library_note": LIBRARY_NOTE,
                "share_of_bound": r["share_of_bound"], "shape": [N, N, 2],
                "dtype": "bfloat16", "bit_equal": r["bit_equal"],
                "mv_ms": r["mv_ms"], "mv_bound_ms": r["mv_bound_ms"],
                "mv_bit_equal": r["mv_bit_equal"],
                "k1_f32_ms": r["k1_f32_ms"],
                "N2048": {k: k3_summary[2048][k] for k in mv_keys}})
    r = k11_summary["whole_256"]
    out.append({"name": "rd3d_jvp_halo", "route": "cuda", "source": SOURCE_3D,
                "replaces": REPLACES["rd3d_jvp_halo"],
                "launches": ws_launches["rd3d_jvp_halo"],
                "launches_in": "weak_scaling", "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None, "library_note": LIBRARY_NOTE,
                "share_of_bound": r["share_of_bound"], "shape": r["shape"],
                "dtype": "float32",
                "shard_64": {k: k11_summary["shard_64"][k]
                             for k in ("ms", "plain_ms", "bound_ms",
                                       "share_of_bound")}})
    r = bsr_summary[("float64", 8)]
    out.append({"name": "bsr_spmm", "route": "cuda", "source": SPMV_SOURCE,
                "replaces": REPLACES["bsr_spmm"], "design": K6_DESIGN,
                "plan": r["plan"], "stage_blocks": r["stage_blocks"],
                "launches": bsr_launches["bsr_spmm"],
                "launches_in": "block_sparse", "tables": r["tables"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "library_note": r["library"],
                "library_call": r["library_call"],
                "share_of_bound": r["share_of_bound"], "shape": r["shape"],
                "dtype": "float64", "k5_columns_ms": r["k5_columns_ms"],
                "k5_columns_index_select_ms":
                    r["k5_columns_index_select_ms"],
                "other": {f"{d}_nrhs{k}": {
                    key: v[key] for key in ("ms", "plain_ms", "bound_ms",
                                            "share_of_bound", "library_ms",
                                            "library_call", "plan",
                                            "k5_columns_ms",
                                            "k5_columns_index_select_ms")}
                    for (d, k), v in bsr_summary.items()
                    if (d, k) != ("float64", 8)}})
    # phase 23 (c): each SpMV kernel's reverse rule on its route's matrix
    for row in out:
        r = vjp_summary.get(row["name"])
        if r is not None:
            row["reverse_rule"] = {
                "tables": r["tables"], "dtype": r["dtype"],
                "launches_per_backward": r["launches_per_backward"],
                "dbar_bit_equal": r["dbar_bit_equal_to_plain"],
                "xbar_rel_err": r["xbar_rel_err"],
                "backward_ms": r["backward_ms"], "xbar_ms": r["xbar_ms"],
                "xbar_bound_ms": r["xbar_bound_ms"],
                "xbar_share_of_bound": r["xbar_share_of_bound"],
                "library_ms": r["library_ms"],
                "library": "cuSPARSE Aᵀ·ȳ",
                "transpose_reuses_forward_plan":
                    r["transpose_reuses_forward_plan"]}
    emit({"phase": "sensitivity_summary",
          "seconds": sens_rec["seconds"],
          "a_forward_rel_err": sens_rec["a_dense"]["forward_rel_err"],
          "b_adjoint_rel_residual":
              sens_rec["b_krylov"]["adjoint_rel_residual"]})
    emit({"kernels": out})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "card": card})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
