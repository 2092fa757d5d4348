from .solvers import solve_riemann, VALID_SOLVERS  # noqa: F401
