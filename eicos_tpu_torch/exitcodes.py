"""Solver exit codes.

Numeric values match EiCOS's ``exitcode`` enum and the classic ECOS C
macros: the "close to" codes are the exact codes offset by +10
(ECOS_INACC_OFFSET).  A copy of ``eicos_tpu.exitcodes``.
"""

import enum


class ExitCode(enum.IntEnum):
    OPTIMAL = 0                      # problem solved to optimality
    PRIMAL_INFEASIBLE = 1            # certificate of primal infeasibility
    DUAL_INFEASIBLE = 2              # certificate of dual infeasibility
    MAXIT = -1                       # maximum number of iterations reached
    NUMERICS = -2                    # search direction unreliable
    OUTCONE = -3                     # s or z left the cone
    FATAL = -7                       # unknown problem in solver
    CLOSE_TO_OPTIMAL = 10
    CLOSE_TO_PRIMAL_INFEASIBLE = 11
    CLOSE_TO_DUAL_INFEASIBLE = 12
    NOT_CONVERGED_YET = -87          # internal sentinel


INACC_OFFSET = 10
