"""nonlinearsolve_tpu_torch — the PyTorch / CUDA port of nonlinearsolve_tpu.

The same problem / algorithm / ``solve`` surface as the JAX package, on
PyTorch tensors, with hand-written CUDA kernels for Hopper (``csrc/``) where
the JAX package had Pallas kernels.  Entry points run on the CUDA device
unless the caller passes ``device="cpu"``; ``solve`` runs on the device of
``prob.u0``.  This package imports neither JAX nor ``nonlinearsolve_tpu``.

Ported so far: Newton–GMRES with the FFT Poisson preconditioner and
Eisenstat–Walker forcing on the 2D Brusselator, matrix-free (the fused
stencil JVP kernels K1, K2) or on a colored sparse-AD Jacobian assembled
into DIA or CSR (the SpMV kernels K4, K5; ``JacobianPolicy(mode="sparse")``
with ``NonlinearFunction(sparsity=...)`` on a flat state); the 3D
reaction–diffusion steady state (``models.reaction_diffusion``),
matrix-free on the 3D stencil JVP kernels K9, K10; the dense solver
surface: dense forward / reverse / finite-difference Jacobians, dense LU /
QR / Cholesky / SVD solves, ``NewtonRaphson`` with the seven line
searches, ``TrustRegion`` with its seven radius schemes,
``LevenbergMarquardt``, ``GaussNewton`` and ``PseudoTransient``, the nine
termination modes and ``NonlinearLeastSquaresProblem``; the quasi-Newton
engine (``Broyden``, ``Klement``, ``LimitedMemoryBroyden``), ``DFSane``,
``AndersonAcceleration`` and the polyalgorithms, so ``solve(prob)`` with
no algorithm runs the JAX package's default ladder; the batched tier: the
simple solvers (``SimpleNewtonRaphson`` … ``SimpleLimitedMemoryBroyden``),
the bracketing methods on ``IntervalNonlinearProblem`` (with the
implicit-function derivative of the root) and ``EnsembleProblem`` /
``solve_ensemble``, a batch running in lockstep on the device;
differentiation through ``solve`` by the implicit-function rule (reverse
and forward mode, second order), with the reverse rules of the SpMV
kernels; bounds, pre- and postconditioning, the initialization hook,
traces, messages, phase timers, ``maxtime`` and the iterator ``init`` /
``step`` / ``solve`` / ``reinit``; continuation (``HomotopyProblem`` with
``HomotopySweep``, ``KantorovichHomotopy``, ``ArcLengthContinuation`` and
``HomotopyPolyAlgorithm``), ``SteadyStateProblem`` with ``SSRootfind`` and
``DynamicSS``, ``SCCNonlinearProblem``, user algorithms with a
``run_flat`` method and the SciPy bridge with the delegating
constructors; pytree, 0-d and complex states (``utils/pytree.py``'s flat
path; holomorphic Jacobians, complex dense and Krylov solves),
normal-form Krylov least squares, and the polynomial drivers
(``solve_polynomial``, ``solve_multistart``, ``HomotopyContinuationJL``),
which track every path in one lockstep batch; complex states under the
engines that order values (JAX's lexicographic order,
``utils/ordering.py``); sparsity detection from the residual's ATen graph
(``ops/sparsity_trace.py``, ``ops.coloring.detect_sparsity``), so a sparse
Jacobian needs no pattern; and double-f32 refinement (``ops/doublef32.py``,
``ops/doublef32_eval.py``, ``refine_root`` / ``auto_refine``).  See
ROADMAP.md for what is still to come.
"""

from .core.autodiff import JacobianPolicy, pickchunksize
from .core.cache import NonlinearSolveCache, init
from .core.conditioning import PostconditionSpace, PostconditionSpecifier
from .core.descent import (DampedNewtonDescent, DescentResult, Dogleg,
                           GeodesicAcceleration, NewtonDescent,
                           SteepestDescent)
from .core.linesearch import (BackTracking, LiFukushimaLineSearch,
                              RobustNonMonotoneLineSearch)
from .core.ensemble import EnsembleProblem, solve_ensemble
from .core.initialization import InitializationData
from .core.problems import (HomotopyProblem, IntervalNonlinearProblem,
                            NonlinearFunction, NonlinearLeastSquaresProblem,
                            NonlinearProblem, SCCNonlinearProblem,
                            SteadyStateProblem)
from .core.returncode import ReturnCode
from .core.solution import NLStats, NonlinearSolution
from .core.solve import solve
from .core.termination import (AbsNormSafeBestTerminationMode,
                               AbsNormSafeTerminationMode,
                               AbsNormTerminationMode, AbsTerminationMode,
                               NormTerminationMode,
                               RelNormSafeBestTerminationMode,
                               RelNormSafeTerminationMode,
                               RelNormTerminationMode, RelTerminationMode,
                               TerminationCondition)
from .core.tracing import (TraceAll, TraceConfig, TraceMinimal,
                           TraceWithJacobianConditionNumber)
from .core.trust_region import (GenericTrustRegionScheme,
                                LevenbergMarquardtTrustRegion,
                                RadiusUpdateSchemes)
from .core.verbosity import NonlinearVerbosity
from .core.wolfe_linesearch import (HagerZhang, LineSearchesJL, MoreThuente,
                                    StaticLineSearch, StrongWolfe)
from .ops.linear_solve import LinearSolver
from .ops.operators import (JacobianOperator, JacVecOperator,
                            StatefulJacobianNormalFormOperator,
                            StatefulJacobianOperator, VecJacOperator)
from .solvers import (ITP, Alefeld, AndersonAcceleration, Bisection, Brent,
                      Broyden, DFSane, Falsi, FastShortcutNLLSPolyalg,
                      FastShortcutNonlinearPolyalg, GaussNewton,
                      GeneralizedDFSane, GeneralizedFirstOrderAlgorithm,
                      Klement, LevenbergMarquardt, LimitedMemoryBroyden,
                      ModAB, Muller, NewtonRaphson,
                      NonlinearSolvePolyAlgorithm, PseudoTransient,
                      QuasiNewtonAlgorithm, Ridder, RobustMultiNewton,
                      SimpleBroyden, SimpleDFSane, SimpleGaussNewton,
                      SimpleHalley, SimpleKlement,
                      SimpleLimitedMemoryBroyden, SimpleNewtonRaphson,
                      SimpleTrustRegion, TrustRegion)
from .solvers.first_order import (EisenstatWalkerForcing,
                                  EisenstatWalkerForcing2)
from .solvers.homotopy_continuation import (HomotopyContinuationJL,
                                            HomotopyNonlinearFunction,
                                            TaylorHomotopyContinuationJL)
from .solvers.multistart import polynomialize, solve_multistart
from .solvers.poly_homotopy import PolynomialHomotopy, solve_polynomial
from .solvers.homotopy import (ArcLengthContinuation,
                               FastShortcutHomotopyPolyalg,
                               HomotopyPolyAlgorithm, HomotopySweep,
                               KantorovichHomotopy, SimpleHomotopySweep)
from .solvers.refinement import RefineResult, auto_refine, refine_root
from .utils.aot import deserialize_solver, export_solver
from .solvers.scc import LinearSCCBlock, SCCAlg, scc_solve_up
from .solvers.steady_state import DynamicSS, SSRootfind
from .solvers.wrappers import (CMINPACK, KINSOL, FastLevenbergMarquardtJL,
                               FixedPointAccelerationJL, LeastSquaresOptimJL,
                               NLsolveJL, NLSolversJL, PETScSNES,
                               SciPyLeastSquares, SciPyLeastSquaresDogbox,
                               SciPyLeastSquaresTRF, SciPyRoot,
                               SciPyRootScalar, SIAMFANLEquationsJL,
                               SpeedMappingJL)

__all__ = [
    "AbsNormSafeBestTerminationMode", "AbsNormSafeTerminationMode",
    "AbsNormTerminationMode", "AbsTerminationMode", "Alefeld",
    "AndersonAcceleration", "ArcLengthContinuation", "BackTracking",
    "Bisection", "Brent", "Broyden", "CMINPACK", "DFSane",
    "DampedNewtonDescent", "DescentResult", "Dogleg", "DynamicSS",
    "EisenstatWalkerForcing", "EisenstatWalkerForcing2", "EnsembleProblem",
    "Falsi", "FastLevenbergMarquardtJL", "FastShortcutHomotopyPolyalg",
    "FastShortcutNLLSPolyalg", "FastShortcutNonlinearPolyalg",
    "FixedPointAccelerationJL", "GaussNewton", "GeneralizedDFSane",
    "GeneralizedFirstOrderAlgorithm", "GenericTrustRegionScheme",
    "GeodesicAcceleration", "HagerZhang", "HomotopyPolyAlgorithm",
    "HomotopyContinuationJL", "HomotopyNonlinearFunction",
    "HomotopyProblem", "HomotopySweep", "ITP", "InitializationData",
    "IntervalNonlinearProblem", "JacVecOperator", "JacobianOperator",
    "JacobianPolicy", "KINSOL", "KantorovichHomotopy", "Klement",
    "LeastSquaresOptimJL", "LevenbergMarquardt",
    "LevenbergMarquardtTrustRegion", "LiFukushimaLineSearch",
    "LimitedMemoryBroyden", "LineSearchesJL", "LinearSCCBlock", "LinearSolver",
    "ModAB", "MoreThuente", "Muller", "NLSolversJL", "NLStats", "NLsolveJL",
    "NewtonDescent", "NewtonRaphson", "NonlinearFunction",
    "NonlinearLeastSquaresProblem", "NonlinearProblem", "NonlinearSolution",
    "NonlinearSolveCache", "NonlinearSolvePolyAlgorithm", "NonlinearVerbosity",
    "NormTerminationMode", "PETScSNES", "PolynomialHomotopy",
    "PostconditionSpace",
    "PostconditionSpecifier", "PseudoTransient", "QuasiNewtonAlgorithm",
    "RadiusUpdateSchemes", "RefineResult", "RelNormSafeBestTerminationMode",
    "RelNormSafeTerminationMode", "RelNormTerminationMode",
    "RelTerminationMode", "ReturnCode", "Ridder", "RobustMultiNewton",
    "RobustNonMonotoneLineSearch", "SCCAlg", "SCCNonlinearProblem",
    "SIAMFANLEquationsJL", "SSRootfind", "SciPyLeastSquares",
    "SciPyLeastSquaresDogbox", "SciPyLeastSquaresTRF", "SciPyRoot",
    "SciPyRootScalar", "SimpleBroyden", "SimpleDFSane", "SimpleGaussNewton",
    "SimpleHalley", "SimpleHomotopySweep", "SimpleKlement",
    "SimpleLimitedMemoryBroyden", "SimpleNewtonRaphson", "SimpleTrustRegion",
    "SpeedMappingJL", "StatefulJacobianNormalFormOperator",
    "StatefulJacobianOperator", "StaticLineSearch",
    "SteadyStateProblem", "SteepestDescent", "StrongWolfe",
    "TaylorHomotopyContinuationJL", "TerminationCondition", "TraceAll",
    "TraceConfig", "TraceMinimal",
    "TraceWithJacobianConditionNumber", "TrustRegion", "VecJacOperator",
    "auto_refine", "deserialize_solver", "export_solver", "init",
    "pickchunksize", "polynomialize", "refine_root",
    "scc_solve_up", "solve",
    "solve_ensemble", "solve_multistart", "solve_polynomial",
]
