from .anderson import AndersonAcceleration
from .first_order import (GaussNewton, GeneralizedFirstOrderAlgorithm,
                          LevenbergMarquardt, NewtonRaphson, PseudoTransient,
                          TrustRegion)
from .polyalg import (FastShortcutNLLSPolyalg, FastShortcutNonlinearPolyalg,
                      NonlinearSolvePolyAlgorithm, RobustMultiNewton)
from .quasi_newton import (Broyden, Klement, LimitedMemoryBroyden,
                           QuasiNewtonAlgorithm)
from .spectral import DFSane, GeneralizedDFSane
