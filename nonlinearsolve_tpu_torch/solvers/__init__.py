from .anderson import AndersonAcceleration
from .first_order import (GaussNewton, GeneralizedFirstOrderAlgorithm,
                          LevenbergMarquardt, NewtonRaphson, PseudoTransient,
                          TrustRegion)
from .polyalg import (FastShortcutNLLSPolyalg, FastShortcutNonlinearPolyalg,
                      NonlinearSolvePolyAlgorithm, RobustMultiNewton)
from .quasi_newton import (Broyden, Klement, LimitedMemoryBroyden,
                           QuasiNewtonAlgorithm)
from .spectral import DFSane, GeneralizedDFSane
from .simple import (SimpleBroyden, SimpleDFSane, SimpleGaussNewton,
                     SimpleHalley, SimpleKlement,
                     SimpleLimitedMemoryBroyden, SimpleNewtonRaphson,
                     SimpleTrustRegion)
from .bracketing import (Alefeld, Bisection, Brent, Falsi, ITP, ModAB,
                         Muller, Ridder)
