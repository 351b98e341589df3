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
matrix-free on the 3D stencil JVP kernels K9, K10; and the dense solver
surface: dense forward / reverse / finite-difference Jacobians, dense LU /
QR / Cholesky / SVD solves, ``NewtonRaphson`` with the seven line
searches, ``TrustRegion`` with its seven radius schemes,
``LevenbergMarquardt``, ``GaussNewton`` and ``PseudoTransient``, the nine
termination modes and ``NonlinearLeastSquaresProblem``.  See ROADMAP.md
for what is still to come.
"""

from .core.autodiff import JacobianPolicy
from .core.linesearch import (BackTracking, LiFukushimaLineSearch,
                              RobustNonMonotoneLineSearch)
from .core.problems import (NonlinearFunction, NonlinearLeastSquaresProblem,
                            NonlinearProblem)
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
from .core.trust_region import (GenericTrustRegionScheme,
                                LevenbergMarquardtTrustRegion,
                                RadiusUpdateSchemes)
from .core.wolfe_linesearch import (HagerZhang, LineSearchesJL, MoreThuente,
                                    StaticLineSearch, StrongWolfe)
from .ops.linear_solve import LinearSolver
from .solvers.first_order import (EisenstatWalkerForcing, GaussNewton,
                                  GeneralizedFirstOrderAlgorithm,
                                  LevenbergMarquardt, NewtonRaphson,
                                  PseudoTransient, TrustRegion)

__all__ = [
    "AbsNormSafeBestTerminationMode", "AbsNormSafeTerminationMode",
    "AbsNormTerminationMode", "AbsTerminationMode", "BackTracking",
    "EisenstatWalkerForcing", "GaussNewton", "GeneralizedFirstOrderAlgorithm",
    "GenericTrustRegionScheme", "HagerZhang", "JacobianPolicy",
    "LevenbergMarquardt", "LevenbergMarquardtTrustRegion",
    "LiFukushimaLineSearch", "LineSearchesJL", "LinearSolver", "MoreThuente",
    "NLStats", "NewtonRaphson", "NonlinearFunction",
    "NonlinearLeastSquaresProblem", "NonlinearProblem", "NonlinearSolution",
    "NormTerminationMode", "PseudoTransient", "RadiusUpdateSchemes",
    "RelNormSafeBestTerminationMode", "RelNormSafeTerminationMode",
    "RelNormTerminationMode", "RelTerminationMode", "ReturnCode",
    "RobustNonMonotoneLineSearch", "StaticLineSearch", "StrongWolfe",
    "TerminationCondition", "TrustRegion", "solve",
]
