"""Command-line driver.

The analogue of the reference's main.c (src/common/main.c:16-58): read an
MPS file, solve, print the status message, write `<name>.out` via the
writesol-compatible writer.  Where the reference ships two binaries (simpo /
ipo) with the algorithm fixed at link time, here `--method` selects from the
runtime registry.

    python -m vanderbei_tpu problem.mps --method hsd
"""

from __future__ import annotations

import argparse
import sys

from .core.config import SolverConfig
from .core.status import status_message
from .io.mps import read_mps
from .io.writer import write_sol
from .models.registry import solve, SOLVERS
from .utils.cache import enable_persistent_cache


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vanderbei_tpu")
    p.add_argument("mps", nargs="+", help="MPS input file(s)")
    p.add_argument("--method", default="hsd", choices=sorted(SOLVERS))
    p.add_argument("--max-iter", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="solution output path")
    p.add_argument("--no-out", action="store_true")
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--free-vars", default="reject",
                   choices=("reject", "split"),
                   help="free (l=-inf) variables: 'reject' matches the "
                        "reference (status 3); 'split' solves them")
    p.add_argument("--precision", default=None,
                   choices=("auto", "mixed", "f32factor", "f64", "dd"),
                   help="precision ladder (default: auto); 'dd' is the "
                        "QuadPrec-equivalent compensated mode")
    p.add_argument("--time-limit", type=float, default=None,
                   help="wall-clock budget in seconds (TIMLIM)")
    p.add_argument("--metrics", default=None, metavar="CSV",
                   help="write the per-iteration structured metrics table "
                        "(device-side scan; hsd only) to this CSV path")
    args = p.parse_args(argv)
    if args.metrics and args.method not in ("hsd", "hsdls"):
        p.error("--metrics requires --method hsd or hsdls "
                "(the device-side scan instruments the HSD loop)")
    enable_persistent_cache()

    banner = (
        "\t+-------------------------------------------------+\n"
        "\t   vanderbei_tpu : JAX LP framework                 \n"
        "\t+-------------------------------------------------+")
    if args.verbose:
        print(banner)

    lp = read_mps(args.mps)
    if args.verbose:
        print(f"m = {lp.m},n = {lp.n},nz = {lp.nz}")

    cfg = SolverConfig(method=args.method, max_iter=args.max_iter,
                       seed=args.seed, verbose=args.verbose,
                       free_vars=args.free_vars)
    if args.precision:
        cfg = cfg.with_(precision=args.precision)
    if args.time_limit is not None:
        cfg = cfg.with_(time_limit=args.time_limit)
    sol = solve(lp, method=args.method, config=cfg)
    if args.metrics:
        _write_metrics_csv(lp, cfg, args.metrics,
                           long_step=(args.method == "hsdls"))
        if args.verbose:
            print(f"metrics table -> {args.metrics}")
    print(status_message(sol.status))
    if args.verbose:
        print(f"primal objective: {sol.primal_obj:.7e}")
        print(f"dual   objective: {sol.dual_obj:.7e}")
        print(f"iterations: {sol.iterations}   "
              f"solve time: {sol.solve_time_s:.3f}s")
    if not args.no_out:
        out = args.out or (lp.name + ".out")
        write_sol(lp, sol, out)
    return 0


def _write_metrics_csv(lp, cfg: SolverConfig, path: str,
                       long_step: bool = False) -> None:
    """Run the observability (scan) variant and dump the per-iteration
    table — the structured counterpart of the reference's stdout trace.

    Traces the same problem configuration as the reported solve: cfg's
    scaling, free-variable policy and dtype, and the requested method's
    loop variant (hsd / hsdls long-step)."""
    import numpy as np
    import jax.numpy as jnp
    from .core.canonicalize import canonicalize
    from .models import hsd

    canon = canonicalize(lp, dtype=cfg.dtype, free_vars=cfg.free_vars,
                         scale=cfg.scale)
    A = jnp.asarray(canon.A)
    max_iter = cfg.max_iter or (hsd.DEFAULT_MAX_ITER_LS if long_step
                                else hsd.DEFAULT_MAX_ITER)
    (st, *_), rows = hsd.solve_canon_metrics(
        A, jnp.asarray(canon.b), jnp.asarray(canon.c), canon.f,
        max_iter=max_iter, eps=cfg.hsd_eps, long_step=long_step,
        beta=cfg.beta, step_factor=cfg.hsd_step_factor,
        epsdiag=cfg.epsdiag, refine_tol=cfg.refine_tol,
        max_refine=cfg.max_refine,
        compensated=(cfg.precision == "dd"))
    cols = ["mu", "primal_obj", "dual_obj", "primal_infeas", "dual_infeas"]
    valid = np.asarray(rows["valid"])
    data = {k: np.asarray(rows[k]) for k in cols}
    with open(path, "w") as fp:
        fp.write("iter," + ",".join(cols) + "\n")
        for i in range(int(valid.sum())):
            fp.write(f"{i}," + ",".join(f"{data[k][i]:.9e}" for k in cols)
                     + "\n")


if __name__ == "__main__":
    sys.exit(main())
