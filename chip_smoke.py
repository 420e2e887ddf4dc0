"""Smoke run of the LP solvers on the GPU, at netlib's large-instance size.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --devices 4   # four cards: the multi-device paths

One process drives the card(s); nothing here starts another JAX process.
Without a GPU the script exits non-zero before any phase runs.

Phases (one card):

- kernels: the normal-matrix assembly (ops/kkt.scaled_syrk, f32 at the
  package's "highest" matmul precision), the f64 Cholesky and the f64
  matvecs, each timed at 4096x8192 and compared with NumPy in f64.  The
  f32 check (<= 1e-5 relative) also proves TF32 is off: TF32 gives ~1e-4.
- lp_ipm: a seeded 4,000 x 8,000 LP (io/synthetic.random_lp) written to MPS
  and solved through the CLI with hsd, hsdls and intpt, then once through
  vt.solve at precision "f64"; each against scipy's HiGHS.  The HiGHS
  solves of every phase run on host threads from the start.
- lp_simplex: pd and twophase through vt.solve on a 1,000 x 2,000 LP.
- batch: 64 LPs of 500 x 1,000 through parallel.batch.solve_batch_hsd,
  every lane against HiGHS.

With --devices 4 only the paths that span cards run, each compared with the
same solve on one card in this process: the 4,000 x 8,000 LP with A's
columns sharded over a ("batch": 1, "model": 4) mesh, and the 64-lane batch
sharded 16 lanes per card over "batch".

Every phase prints its compile and solve seconds, iterations, statuses,
objectives, errors and the device's peak memory.  A failed check raises and
the script exits non-zero.  The last line of a passing run is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# sizes of the one-card run; the phase functions take them as arguments
IPM_SHAPE = (4000, 8000)       # netlib's large end: GREENBEA, D2Q06C, FIT2P
SIMPLEX_SHAPE = (1000, 2000)   # dense B^-1 stops near m = 2k
BATCH_SHAPE = (500, 1000)
BATCH_LANES = 64
KERNEL_SHAPE = (4096, 8192)
# netlib's large instances carry 2-6 nonzeros per column (80BAU3B 2.2,
# FIT2P 3.7, GREENBEA 5.8); at 20 per column HiGHS, the reference, needs
# minutes per LP on the host
NNZ_PER_COL = 5
UB_FRAC = 0.25
SEED = 0
OBJ_RTOL = 1e-6                # against HiGHS
SHARDED_RTOL = 1e-9            # sharded against one card


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def rel_err(a: float, b: float) -> float:
    return abs(a - b) / max(1.0, abs(b))


class CompileClock:
    """Seconds JAX has spent lowering jitted functions to XLA and compiling
    them so far (tracing, which nests, is left out)."""

    EVENTS = ("/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, name, secs, **_):
        if name in self.EVENTS:
            self.total += secs


def peak_bytes(device) -> int | None:
    """Peak bytes the program's arrays have held on `device` (None where
    the backend keeps no statistics, as on the CPU)."""
    stats = device.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def report(phase: str, **fields) -> None:
    import jax
    fields.setdefault("peak_bytes", peak_bytes(jax.devices()[0]))
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def make_lp(m: int, n: int, seed: int):
    from vanderbei_tpu.io.synthetic import random_lp
    return random_lp(m, n, density=min(1.0, NNZ_PER_COL / m),
                     ub_frac=UB_FRAC, seed=seed)


class References:
    """HiGHS solves of the phases' LPs on host threads.  HiGHS releases the
    GIL, so solves asked for early run while the card works."""

    def __init__(self, workers: int = 4):
        from concurrent.futures import ThreadPoolExecutor
        self._pool = ThreadPoolExecutor(workers)
        self._futures = {}

    def highs(self, m: int, n: int, seed: int):
        """Future of (status, objective) for make_lp(m, n, seed)."""
        from vanderbei_tpu.io.synthetic import highs_reference
        key = (m, n, seed)
        if key not in self._futures:
            self._futures[key] = self._pool.submit(
                lambda: highs_reference(make_lp(m, n, seed)))
        return self._futures[key]

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


# --------------------------------------------------------------------------
# one card
# --------------------------------------------------------------------------

def phase_kernels(m: int, n: int, seed: int = SEED) -> dict:
    """Time the IPM's dense kernels against NumPy f64 references."""
    import jax
    import jax.numpy as jnp
    from vanderbei_tpu.ops.kkt import scaled_syrk
    from vanderbei_tpu.utils.profiling import time_fn

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * 10.0 ** rng.uniform(-1, 1, (m, n))
    s = rng.uniform(0.1, 10.0, n)
    e = rng.uniform(0.1, 1.0, m)
    out = {}

    # (a) normal-matrix assembly in f32
    syrk = jax.jit(scaled_syrk, static_argnames="dtype")
    secs, M = time_fn(syrk, jnp.asarray(A, jnp.float32),
                      jnp.asarray(s, jnp.float32),
                      jnp.asarray(e, jnp.float32), dtype=jnp.float32)
    ref = (A * s) @ A.T + np.diag(e)
    err = float(np.linalg.norm(np.asarray(M, np.float64) - ref)
                / np.linalg.norm(ref))
    report("kernels.syrk_f32", shape=f"{m}x{n}", seconds=secs, rel_err=err)
    check(err <= 1e-5, f"f32 assembly error {err:.3e} > 1e-5 (TF32 on?)")
    out["syrk_f32_s"] = secs

    # (b) f64 Cholesky of an SPD m x m matrix
    G = rng.standard_normal((m, m))
    S = G @ G.T / m + np.eye(m)
    secs, L = time_fn(jax.jit(jnp.linalg.cholesky), jnp.asarray(S))
    L = np.asarray(L)
    err = float(np.linalg.norm(S - L @ L.T) / np.linalg.norm(S))
    report("kernels.cholesky_f64", shape=f"{m}x{m}", seconds=secs,
           rel_err=err)
    check(err <= 1e-12, f"f64 Cholesky residual {err:.3e} > 1e-12")
    out["cholesky_f64_s"] = secs

    # (c) f64 matvecs against A and A'
    A_dev = jnp.asarray(A)
    v = rng.standard_normal(n)
    w = rng.standard_normal(m)
    for name, fn, vec, ref in (
            ("matvec_f64", jax.jit(lambda A, v: A @ v), v, A @ v),
            ("rmatvec_f64", jax.jit(lambda A, w: A.T @ w), w, A.T @ w)):
        secs, y = time_fn(fn, A_dev, jnp.asarray(vec), reps=10)
        err = float(np.linalg.norm(np.asarray(y) - ref)
                    / np.linalg.norm(ref))
        report(f"kernels.{name}", shape=f"{m}x{n}", seconds=secs,
               rel_err=err)
        check(err <= 1e-12, f"{name} error {err:.3e} > 1e-12")
        out[f"{name}_s"] = secs
    return out


def _run_cli(argv: list[str]) -> dict:
    """vanderbei_tpu.cli.main in this process; parses what it prints."""
    from vanderbei_tpu import cli
    from vanderbei_tpu.core.status import STATUS_MESSAGES

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    check(rc == 0, f"cli exited {rc}:\n{text}")
    res = {}
    for line in text.splitlines():
        line = line.strip()
        if line in STATUS_MESSAGES:
            res["status"] = STATUS_MESSAGES.index(line)
        elif line.startswith("primal objective:"):
            res["objective"] = float(line.split(":")[1])
        elif line.startswith("iterations:"):
            toks = line.split()
            res["iterations"] = int(toks[1])
            res["solve_s"] = float(toks[-1].rstrip("s"))
    check({"status", "objective", "iterations"} <= set(res),
          f"unparsed cli output:\n{text}")
    return res


def phase_lp_ipm(m: int, n: int, clock: CompileClock, refs: References,
                 workdir: str, seed: int = SEED) -> dict:
    """The IPMs on one seeded LP: CLI for hsd/hsdls/intpt, vt.solve f64."""
    import vanderbei_tpu as vt
    from vanderbei_tpu.core.status import Status

    lp = make_lp(m, n, seed)
    path = os.path.join(workdir, f"lp_{m}x{n}.mps")
    vt.write_lp(lp, path)
    ref = refs.highs(m, n, seed)
    out = {}
    for method, extra in (("hsd", []), ("hsdls", []),
                          # path-following with fixed centering used 163
                          # of the reference's 200 iterations (intpt.c:31)
                          # at 4,000 x 8,000; headroom for other seeds
                          ("intpt", ["--max-iter", "500"])):
        c0, t0 = clock.total, time.perf_counter()
        res = _run_cli([path, "--method", method, "--out",
                        os.path.join(workdir, f"{method}.out")] + extra)
        wall = time.perf_counter() - t0
        if "highs_objective" not in out:
            t0 = time.perf_counter()
            h_status, h_obj = ref.result()
            report("lp_ipm.highs", shape=f"{m}x{n}", nnz=lp.nz,
                   status=h_status, objective=repr(h_obj),
                   waited_s=time.perf_counter() - t0)
            check(h_status == Status.OPTIMAL, f"HiGHS status {h_status}")
            out["highs_objective"] = h_obj
        err = rel_err(res["objective"], h_obj)
        report(f"lp_ipm.cli_{method}", wall_s=wall,
               compile_s=clock.total - c0, solve_s=res["solve_s"],
               iterations=res["iterations"], status=res["status"],
               objective=repr(res["objective"]), highs_objective=repr(h_obj),
               rel_err=err)
        check(res["status"] == Status.OPTIMAL,
              f"{method}: status {res['status']}")
        check(err <= OBJ_RTOL, f"{method}: objective rel err {err:.3e}")
        out[method] = res

    c0, t0 = clock.total, time.perf_counter()
    sol = vt.solve(lp, config=vt.SolverConfig(precision="f64"))
    wall = time.perf_counter() - t0
    err = rel_err(sol.primal_obj, h_obj)
    report("lp_ipm.solve_hsd_f64", wall_s=wall, compile_s=clock.total - c0,
           solve_s=sol.solve_time_s, iterations=sol.iterations,
           status=sol.status, objective=repr(sol.primal_obj),
           highs_objective=repr(h_obj), rel_err=err)
    check(sol.status == Status.OPTIMAL, f"hsd f64: status {sol.status}")
    check(err <= OBJ_RTOL, f"hsd f64: objective rel err {err:.3e}")
    out["hsd_f64"] = sol.primal_obj
    return out


def phase_lp_simplex(m: int, n: int, clock: CompileClock, refs: References,
                     seed: int = SEED) -> dict:
    """pd and twophase through vt.solve on one seeded LP."""
    import vanderbei_tpu as vt
    from vanderbei_tpu.core.status import Status

    lp = make_lp(m, n, seed)
    h_status, h_obj = refs.highs(m, n, seed).result()
    check(h_status == Status.OPTIMAL, f"HiGHS status {h_status}")
    out = {}
    for method in ("pd", "twophase"):
        c0, t0 = clock.total, time.perf_counter()
        sol = vt.solve(lp, method=method)
        wall = time.perf_counter() - t0
        err = rel_err(sol.primal_obj, h_obj)
        report(f"lp_simplex.{method}", shape=f"{m}x{n}", wall_s=wall,
               compile_s=clock.total - c0, solve_s=sol.solve_time_s,
               iterations=sol.iterations, status=sol.status,
               objective=repr(sol.primal_obj), highs_objective=repr(h_obj),
               rel_err=err)
        check(sol.status == Status.OPTIMAL,
              f"{method}: status {sol.status}")
        check(err <= OBJ_RTOL, f"{method}: objective rel err {err:.3e}")
        out[method] = sol.primal_obj
    return out


def batch_operands(m: int, n: int, lanes: int, seed: int = SEED):
    """Stack `lanes` seeded LPs into one structured (UbTail) class, as the
    batched sweep does.  Returns (canons, (A1, b, c, ub))."""
    import jax
    import jax.numpy as jnp
    from vanderbei_tpu.parallel import batch as pbatch

    lps = [make_lp(m, n, seed + k) for k in range(lanes)]
    classes, aborted = pbatch.group_by_class(
        lps, granularity=128, use_ub_structure=True, scale="geometric")
    check(not aborted and len(classes) == 1,
          f"batch did not form one class: {list(classes)}")
    (key, entries), = classes.items()
    check(key[0] == "s", f"batch class {key} is not structured")
    _, M1, N, K = key
    A1, b, c, ub = pbatch.stack_class_structured_device(entries, M1, N, K)
    canons = [canon for _, canon in entries]
    return canons, (A1, jnp.asarray(b), jnp.asarray(c),
                         jax.tree.map(jnp.asarray, ub))


def batch_objectives(canons, c, x) -> np.ndarray:
    c, x = np.asarray(c), np.asarray(x)
    return np.array([
        (1.0 if cn.maximize else -1.0)
        * (cn.obj_scale * float(c[j, :cn.n] @ x[j, :cn.n]) + cn.f)
        for j, cn in enumerate(canons)])


def phase_batch(m: int, n: int, lanes: int, clock: CompileClock,
                refs: References, seed: int = SEED) -> dict:
    """`lanes` LPs through one vmapped solve_batch_hsd, each vs HiGHS."""
    import jax
    from vanderbei_tpu.core.status import Status
    from vanderbei_tpu.parallel.batch import solve_batch_hsd

    canons, (A1, b, c, ub) = batch_operands(m, n, lanes, seed)
    c0, t0 = clock.total, time.perf_counter()
    st, x, _, _, _, iters = jax.block_until_ready(
        solve_batch_hsd(A1, b, c, ub=ub))
    wall = time.perf_counter() - t0
    compile_s = clock.total - c0
    t0 = time.perf_counter()
    st, x, _, _, _, iters = jax.block_until_ready(
        solve_batch_hsd(A1, b, c, ub=ub))
    solve_s = time.perf_counter() - t0
    st, iters = np.asarray(st), np.asarray(iters)
    objs = batch_objectives(canons, c, x)
    refs = [refs.highs(m, n, seed + k).result() for k in range(lanes)]
    errs = np.array([rel_err(o, r[1]) for o, r in zip(objs, refs)])
    report("batch.solve_batch_hsd", lanes=lanes, shape=f"{m}x{n}",
           operand=f"{tuple(A1.shape)}", first_call_s=wall,
           compile_s=compile_s, solve_s=solve_s,
           iterations_max=int(iters.max()),
           optimal=int((st == Status.OPTIMAL).sum()),
           max_rel_err=float(errs.max()))
    check(all(r[0] == Status.OPTIMAL for r in refs), "HiGHS not optimal")
    check(bool((st == Status.OPTIMAL).all()),
          f"non-optimal lanes: {np.nonzero(st != Status.OPTIMAL)[0]}")
    check(float(errs.max()) <= OBJ_RTOL,
          f"lane objective rel err {errs.max():.3e}")
    return {"objectives": objs, "status": st}


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------

def _check_spread(devices, min_bytes: int, what: str) -> None:
    """Each device must have held at least min_bytes: nothing of the
    sharded solve may have collapsed onto device 0."""
    peaks = [peak_bytes(d) for d in devices]
    print(f"[{what}] per-device peak_bytes={peaks}", flush=True)
    if None not in peaks:
        check(min(peaks) >= min_bytes,
              f"{what}: a device held < {min_bytes} bytes: {peaks}")


def phase_sharded_lp(m: int, n: int, n_dev: int, clock: CompileClock,
                     seed: int = SEED) -> dict:
    """One LP, A's columns sharded n_dev ways, against one device."""
    import jax
    import vanderbei_tpu as vt
    from vanderbei_tpu.core.status import Status
    from vanderbei_tpu.parallel.mesh import make_mesh

    lp = make_lp(m, n, seed)
    res = {}
    for tag, mesh in (("one_device", None),
                      ("sharded", make_mesh(n_dev, model_parallel=n_dev))):
        c0, t0 = clock.total, time.perf_counter()
        sol = vt.solve(lp, method="hsd", mesh=mesh)
        report(f"sharded_lp.{tag}", devices=1 if mesh is None else n_dev,
               wall_s=time.perf_counter() - t0, compile_s=clock.total - c0,
               solve_s=sol.solve_time_s, iterations=sol.iterations,
               status=sol.status, objective=repr(sol.primal_obj))
        res[tag] = sol
    one, tp = res["one_device"], res["sharded"]
    check(one.status == tp.status == Status.OPTIMAL,
          f"statuses {one.status} (one) / {tp.status} (sharded)")
    err = rel_err(tp.primal_obj, one.primal_obj)
    print(f"[sharded_lp.compare] rel_err={err}", flush=True)
    check(err <= SHARDED_RTOL, f"sharded vs one device: {err:.3e}")
    # a shard of the f64 head operand on every device
    _check_spread(jax.devices()[:n_dev], m * n * 8 // (2 * n_dev),
                  "sharded_lp")
    return {"one_device": one.primal_obj, "sharded": tp.primal_obj}


def phase_sharded_batch(m: int, n: int, lanes: int, n_dev: int,
                        clock: CompileClock, seed: int = SEED) -> dict:
    """The batch sharded over the "batch" axis against one device."""
    import jax
    from vanderbei_tpu.core.status import Status
    from vanderbei_tpu.ops.kkt import UbTail
    from vanderbei_tpu.parallel.batch import shard_batch, solve_batch_hsd
    from vanderbei_tpu.parallel.mesh import make_mesh

    check(lanes % n_dev == 0, f"{lanes} lanes over {n_dev} devices")
    canons, (A1, b, c, ub) = batch_operands(m, n, lanes, seed)
    mesh = make_mesh(n_dev, model_parallel=1)
    A1s, bs, cs, idx2s, w2s = shard_batch([A1, b, c, ub.idx2, ub.w2], mesh)
    res = {}
    for tag, args in (("one_device", (A1, b, c, ub)),
                      ("sharded", (A1s, bs, cs, UbTail(idx2s, w2s)))):
        c0, t0 = clock.total, time.perf_counter()
        out = jax.block_until_ready(
            solve_batch_hsd(*args[:3], ub=args[3]))
        report(f"sharded_batch.{tag}", lanes=lanes,
               devices=len(out[1].sharding.device_set),
               wall_s=time.perf_counter() - t0, compile_s=clock.total - c0)
        res[tag] = out
    (st1, x1, *_), (st4, x4, *_) = res["one_device"], res["sharded"]
    check(len(x4.sharding.device_set) == n_dev,
          f"sharded result on {len(x4.sharding.device_set)} devices")
    st1, st4 = np.asarray(st1), np.asarray(st4)
    check(bool((st1 == Status.OPTIMAL).all()) and bool((st1 == st4).all()),
          f"statuses one={st1} sharded={st4}")
    o1 = batch_objectives(canons, c, x1)
    o4 = batch_objectives(canons, c, x4)
    err = float(max(rel_err(a, b_) for a, b_ in zip(o4, o1)))
    print(f"[sharded_batch.compare] max_rel_err={err}", flush=True)
    check(err <= SHARDED_RTOL, f"sharded batch vs one device: {err:.3e}")
    # each device held its lanes' head operands
    _check_spread(jax.devices()[:n_dev], A1.nbytes // (2 * n_dev),
                  "sharded_batch")
    return {"one_device": o1, "sharded": o4}


# --------------------------------------------------------------------------

def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, choices=(1, 4), default=1,
                   help="4: run only the paths that span four cards")
    args = p.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    if len(devices) < args.devices:
        print(f"chip_smoke: --devices {args.devices} but JAX sees "
              f"{len(devices)}", file=sys.stderr)
        return 2

    from vanderbei_tpu.utils.cache import enable_persistent_cache
    print(f"compile cache: {enable_persistent_cache()}", flush=True)
    print(nvidia_smi(), flush=True)
    kind = devices[0].device_kind
    print(f"device_kind={kind} count={len(devices)}", flush=True)
    clock = CompileClock()
    t_start = time.perf_counter()

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        fn(*a)
        print(f"[{name}] phase_wall_s={time.perf_counter() - t0}",
              flush=True)

    if args.devices == 4:
        timed("sharded_lp", phase_sharded_lp, *IPM_SHAPE, 4, clock)
        timed("sharded_batch", phase_sharded_batch, *BATCH_SHAPE,
              BATCH_LANES, 4, clock)
    else:
        refs = References()
        try:
            # the HiGHS solves start now and overlap the card's phases
            refs.highs(*IPM_SHAPE, SEED)
            refs.highs(*SIMPLEX_SHAPE, SEED)
            for k in range(BATCH_LANES):
                refs.highs(*BATCH_SHAPE, SEED + k)
            timed("kernels", phase_kernels, *KERNEL_SHAPE)
            with tempfile.TemporaryDirectory() as workdir:
                timed("lp_ipm", phase_lp_ipm, *IPM_SHAPE, clock, refs,
                      workdir)
            timed("lp_simplex", phase_lp_simplex, *SIMPLEX_SHAPE, clock,
                  refs)
            timed("batch", phase_batch, *BATCH_SHAPE, BATCH_LANES, clock,
                  refs)
        finally:
            refs.close()
    print(f"total_wall_s={time.perf_counter() - t_start} "
          f"compile_s={clock.total}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
