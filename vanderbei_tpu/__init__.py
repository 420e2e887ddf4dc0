"""vanderbei_tpu — a JAX linear/quadratic programming framework.

A from-scratch JAX/XLA re-design of the capabilities of the C companion
code to Vanderbei's *Linear Programming: Foundations and Extensions*
(reference: romz-pl/linear-programming-Vanderbei).  Not a port: solvers are
expressed as jit-compiled ``lax.while_loop`` pipelines over dense, padded
arrays, batched with ``vmap`` and sharded over device meshes with
``jax.sharding`` — replacing the reference's single-threaded pointer-chasing
sparse kernels.

Public API:
    read_mps(path)            -> LP          (io/mps.py; reference src/common/iolp.c)
    canonicalize(lp)          -> CanonLP     (core/canonicalize.py; reference src/common/solve.c)
    solve(lp, method=...)     -> Solution    (models/registry.py; reference link-time METHOD= choice)
    write_sol(lp, sol, path)                 (io/writer.py; reference writesol iolp.c:976)
"""

import jax as _jax

# The reference framework is a double-precision numerical code (with an
# optional double-double mode).  f64 is required to hit its tolerance ladder
# (mu < 1e-12 in hsd.c:24).
_jax.config.update("jax_enable_x64", True)

# On the GPU an f32 matmul at default precision runs in TF32 (about three
# decimal digits); the mixed-precision KKT factor needs true f32 products or
# the refinement loses the problem.
_jax.config.update("jax_default_matmul_precision", "highest")

from .core.lp import LP, Solution  # noqa: E402
from .core.status import Status, STATUS_MESSAGES  # noqa: E402
from .core.canonicalize import canonicalize, CanonLP  # noqa: E402
from .core.config import SolverConfig  # noqa: E402
from .io.mps import read_mps  # noqa: E402
from .io.writer import write_sol, write_lp  # noqa: E402
from .models.registry import solve, get_solver, SOLVERS  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "LP",
    "Solution",
    "Status",
    "STATUS_MESSAGES",
    "canonicalize",
    "CanonLP",
    "SolverConfig",
    "read_mps",
    "write_sol",
    "write_lp",
    "solve",
    "get_solver",
    "SOLVERS",
]
