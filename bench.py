"""Benchmark: FULL netlib corpus throughput vs the reference C solver.

Prints ONE JSON line:
    {"metric": "netlib_problems_per_min", "value": N, "unit": "problems/min",
     "vs_baseline": R, ...extras}

Honesty rules:
- every rep re-solves on FRESH rhs values (a per-problem 1e-9-relative
  scalar jiggle: objectives move ~1e-9 relative, far inside the 1e-6
  check, but the launch content is new — a per-ROW jiggle would break the
  consistency of canonical equality-row pairs);
- the timed region is the full production path — stack/canonicalize,
  solve, and FETCH results to the HOST (async dispatch cannot fake
  completion: the fetch blocks until the math is done);
- value = MEDIAN problems/min over N_REP reps; all rep times reported;
- implied TF/s from a dense-FLOP model accompanies the headline;
- compile/warmup is reported separately (persistent cache .jax_cache
  makes it a one-time cost per machine).

Workload: EVERY on-disk netlib instance the reference can itself run to a
solution (free-variable instances abort identically fast on both sides
and are excluded from both).  Small/mid problems (canonical size class
<= 1024 both dims) run through the batched production path — vmapped
two-stage HSD over padded size classes with the UbTail structured KKT
and geometric+norm scaling; larger problems run per-problem through
registry.solve (the same path the evaluate/ sweep uses, so its compile
cache is shared).  The reference's own per-problem cost grows ~cubically
with size, so the full corpus is the honest workload.

vs_baseline: the reference C ipo binary (hsd build, -O2, one CPU core of
this host) timed end-to-end on the same MPS files; measured once and
cached (keyed by the problem list) because it takes ~15 minutes.

BASELINE.json north-star metrics reported: ipm_iterations_per_s (total
iterations / median sweep seconds) and kkt_ms_per_chip (median over
batched classes of sweep-time / while-loop trip count — each trip is one
batched KKT factorization + its solves across the class).

Needs the netlib corpus; without it the script exits non-zero.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import vanderbei_tpu  # noqa: E402  (enables x64)
from vanderbei_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

from vanderbei_tpu.core.canonicalize import canonicalize  # noqa: E402
from vanderbei_tpu.core.status import Status  # noqa: E402
from vanderbei_tpu.io import netlib  # noqa: E402
from vanderbei_tpu.models.registry import size_class  # noqa: E402
from vanderbei_tpu.parallel import batch as pbatch  # noqa: E402

MAX_BATCH = 2048      # batched-path cap; larger problems solve per-problem
GRAN = 512            # batched-class granularity (few compiles, good fill)
N_REP_MAX = 5

REF_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".refbuild")
# committed single-core C baseline (scripts/time_reference_baseline.py);
# machine-stable, so bench never pays the ~15-minute measurement again
REF_TIMES_COMMITTED = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "bench_ref_times.json")
# wall budget for the WHOLE script; reps degrade 5 -> 1 to fit it
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "1800"))
# per-problem + per-class detail lands here, so a reader of the output's
# tail only ever needs the compact LAST line
DETAIL_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "BENCH_DETAIL.json")


def class_tag(key) -> str:
    return "x".join(str(k) for k in key)


def pick_problems(excluded):
    """The full solvable corpus: batched classes + a per-problem big list.

    Returns (classes, big, names_all) where classes maps a batch key to
    [(name, lp, canon), ...] and big is [(name, lp), ...] ordered smallest
    first.
    """
    from vanderbei_tpu.core.canonicalize import canon_dims
    small_names, small_lps, big = [], [], []
    for name in netlib.available_problems():
        lp = netlib.load(name)
        # dims-only probe (canon_dims): the XL instances' dense canonical
        # arrays cost minutes of host time each to materialize here
        mc, nc, st_probe = canon_dims(lp)
        if st_probe != int(Status.RUNNING):
            continue    # free-variable instances: reference aborts too
        if size_class(mc) <= MAX_BATCH and size_class(nc) <= MAX_BATCH:
            small_names.append(name)
            small_lps.append(lp)
        else:
            if name not in excluded:
                big.append((name, lp))
    classes, _ = pbatch.group_by_class(small_lps, granularity=GRAN,
                                       use_ub_structure=True,
                                       scale="geometric")
    out = {}
    for key, entries in classes.items():
        if class_tag(key) in excluded:
            continue
        out[key] = [(small_names[i], small_lps[i], canon)
                    for i, canon in entries]
    names_all = ([n for v in out.values() for n, _, _ in v]
                 + [n for n, _ in big])
    return out, big, names_all


def build_reference():
    src = "/root/reference/src"
    if not os.path.isdir(src):
        return None
    binary = os.path.join(REF_BUILD, "ipo_hsd")
    if os.path.exists(binary):
        return binary
    try:
        os.makedirs(REF_BUILD, exist_ok=True)
        subprocess.run(["cp", "-r", src, os.path.join(REF_BUILD, "src")],
                       check=True)
        common = ["main", "solve", "iolp", "hash", "cputime", "strdup",
                  "hook", "tree", "heap", "linalg", "noamplio"]
        srcs = [os.path.join(REF_BUILD, "src", "common", f"{c}.c")
                for c in common]
        srcs += [os.path.join(REF_BUILD, "src", "ipo", f)
                 for f in ("hsd.c", "ldlt.c")]
        subprocess.run(
            ["gcc", "-O2", "-w",
             "-I", os.path.join(REF_BUILD, "src", "common"),
             "-I", os.path.join(REF_BUILD, "src", "ipo")]
            + srcs + ["-lm", "-o", binary],
            check=True, capture_output=True)
        return binary
    except Exception:
        return None


def time_reference(binary, names):
    """Single-core wall time of the reference ipo on the same MPS files.

    Primary source: the COMMITTED per-problem measurements
    (bench_ref_times.json, produced by scripts/time_reference_baseline.py
    with returncode + reported-status bookkeeping).  Only runs with rc=0
    count as valid baseline timings; names missing from the artifact are
    measured here (same rc discipline).  Returns
    (total_s, valid_names, n_failed) — vs_baseline is computed over the
    intersection of valid baseline rows and the benched problem list, so a
    reference timeout/crash can neither inflate nor fake the ratio.
    """
    cache = {}
    if os.path.exists(REF_TIMES_COMMITTED):
        with open(REF_TIMES_COMMITTED) as fp:
            cache = json.load(fp)
    total = 0.0
    valid = []
    failed = 0
    for name in names:
        ent = cache.get(name)
        if ent is None and binary:
            path = os.path.join(netlib.netlib_dir(),
                                netlib.NETLIB_GOLDEN[name][0])
            t0 = time.perf_counter()
            try:
                proc = subprocess.run([binary, path], capture_output=True,
                                      timeout=1800, cwd=REF_BUILD)
                ent = {"seconds": time.perf_counter() - t0,
                       "rc": proc.returncode}
            except subprocess.TimeoutExpired:
                ent = {"seconds": 1800.0, "rc": -9}
            cache[name] = ent
        if ent is None or ent.get("rc") != 0:
            failed += 1
            continue
        total += ent["seconds"]
        valid.append(name)
    return total, valid, failed


def solve_class(key, entries, jiggle, rng):
    """Stack one batched class (with per-lane scalar rhs jiggle) and run
    the batched two-stage solve; returns per-problem records + class
    timing facts.

    Lanes the HSD quality gate flags SUBOPTIMAL (phi collapse,
    models/hsd.py) re-solve through the registry's intpt fallback — the
    same cross-family fallback the single-problem production path takes —
    inside the timed region."""
    from vanderbei_tpu.models.registry import solve as registry_solve
    structured = key[0] == "s"
    canons = [canon for _, _, canon in entries]
    if structured:
        _, M1, N, K = key
        A, b, c, ub = pbatch.stack_class_structured_device(
            [(None, canon) for canon in canons], M1, N, K)
        ub = jax.tree.map(jnp.asarray, ub)
    else:
        _, M, N = key
        A, b, c = pbatch.stack_class_device(
            [(None, canon) for canon in canons], M, N)
        ub = None
    if jiggle:
        # PER-LANE scalar: independent per-row noise would make canonical
        # equality-row pairs inconsistent (artificially near-infeasible)
        b = b * (1.0 + 1e-9 * jiggle
                 * rng.uniform(0.5, 1.0, (b.shape[0], 1)))
    st, x, y, w, z, iters = pbatch.solve_batch_hsd(
        A, jnp.asarray(b), jnp.asarray(c), ub=ub)
    # REAL completion: fetch everything the practical path consumes
    st = np.asarray(st)
    x = np.asarray(x)
    iters = np.asarray(iters)
    recs = []
    for j, (name, lp, canon) in enumerate(entries):
        n = canon.n
        sign = 1.0 if canon.maximize else -1.0
        obj = sign * (canon.obj_scale
                      * float(np.asarray(c[j])[:n] @ x[j][:n]) + canon.f)
        if int(st[j]) != int(Status.OPTIMAL):
            # primary-path per-problem re-solve, quality retries OFF:
            # bench times the production path; a SUBOPTIMAL verdict is
            # counted honestly in the mismatch accounting rather than
            # paying a ~1000s retry chain per rep (GREENBEA class)
            sol = registry_solve(lp, method="hsd", config=BENCH_CFG)
            recs.append((name, sol.status, sol.primal_obj,
                         int(iters[j]) + sol.iterations))
        else:
            recs.append((name, int(st[j]), obj, int(iters[j])))
    return recs


def solve_big(name, lp, jiggle, rng):
    """Per-problem production solve for beyond-batch-size instances —
    the same registry path (and compile cache) the evaluate sweep uses."""
    from vanderbei_tpu.models.registry import solve as registry_solve
    if jiggle:
        import copy
        lp = copy.copy(lp)
        lp.b = lp.b * (1.0 + 1e-9 * jiggle * float(rng.uniform(0.5, 1.0)))
    sol = registry_solve(lp, method="hsd", config=BENCH_CFG)
    return [(name, sol.status, sol.primal_obj, sol.iterations)]


# bench solves run the primary production path; quality-gate retry
# chains belong to the evaluate/ correctness trees, not the timed region
from vanderbei_tpu.core.config import SolverConfig  # noqa: E402
BENCH_CFG = SolverConfig(quality_retries=False)


def main():
    t_script0 = time.perf_counter()
    excludes = set(filter(None, os.environ.get(
        "BENCH_EXCLUDE", "").split(",")))
    classes, big, names_all = pick_problems(excludes)
    if not classes and not big:
        print(f"bench: no netlib problems under {netlib.netlib_dir()}",
              file=sys.stderr)
        return 1
    n_problems = sum(len(v) for v in classes.values()) + len(big)

    rng = np.random.default_rng(12345)

    def sweep_once(jiggle):
        recs = []
        per_class = {}
        for key, entries in classes.items():
            t0 = time.perf_counter()
            out = solve_class(key, entries, jiggle, rng)
            per_class[class_tag(key)] = dict(
                seconds=round(time.perf_counter() - t0, 3),
                n=len(entries),
                max_iters=max(r[3] for r in out),
                sum_iters=sum(r[3] for r in out))
            recs.extend(out)
        for name, lp in big:
            t0 = time.perf_counter()
            out = solve_big(name, lp, jiggle, rng)
            per_class[name] = dict(
                seconds=round(time.perf_counter() - t0, 3), n=1,
                max_iters=out[0][3], sum_iters=out[0][3])
            recs.extend(out)
        return recs, per_class

    # warmup/compile: one pass (the persistent cache makes re-runs cheap)
    t0 = time.perf_counter()
    sweep_once(0.0)
    compile_s = time.perf_counter() - t0

    # budget-adaptive reps: never overrun BUDGET_S; 1 rep minimum
    rep_times = []
    records = per_class = None
    while len(rep_times) < N_REP_MAX:
        used = time.perf_counter() - t_script0
        est = (np.median(rep_times) if rep_times
               else max(compile_s * 0.5, 30.0))
        if rep_times and used + est > BUDGET_S * 0.75:
            break
        t0 = time.perf_counter()
        records, per_class = sweep_once(float(len(rep_times) + 1))
        rep_times.append(time.perf_counter() - t0)
    records = [tuple(r) for r in records]
    elapsed = float(np.median(rep_times))
    ppm = 60.0 * n_problems / elapsed

    # correctness + implied-FLOPs accounting on the final rep
    solved = correct = total_iters = 0
    mismatches = []
    flops = 0.0
    for key, entries in classes.items():
        mp, np_ = key[1], key[2]
        kdim = min(mp, np_)
        per_iter = (2.0 * mp * np_ * kdim + kdim ** 3 / 3.0
                    + 12.0 * kdim ** 2 + 8.0 * mp * np_) * len(entries)
        flops += per_class[class_tag(key)]["max_iters"] * per_iter
    for name, lp in big:
        canon_rows = netlib.NETLIB_GOLDEN[name][1]
        canon_cols = netlib.NETLIB_GOLDEN[name][2]
        kdim = min(canon_rows, canon_cols)
        per_iter = (2.0 * canon_rows * canon_cols * kdim + kdim ** 3 / 3.0)
        flops += per_class[name]["sum_iters"] * per_iter
    from vanderbei_tpu.evaluate import reference_outcomes
    ref_achieved = reference_outcomes("hsd")
    sense = {name: (1.0 if netlib.load(name).maximize else -1.0)
             for name in [r[0] for r in records]}
    for name, st, obj, iters in records:
        total_iters += iters
        if st == int(Status.OPTIMAL):
            solved += 1
            golden = netlib.ondisk_objective(name)
            ok = abs(obj - golden) / max(1.0, abs(golden)) < 1e-6
            if not ok and name in ref_achieved:
                # a handful of on-disk file revisions differ from the
                # published table; agreeing with the reference binary's
                # ACHIEVED objective on the same file counts (signed
                # solver-view comparison, like evaluate.py)
                try:
                    ra = float(ref_achieved[name])
                    ok = (abs(ra - sense[name] * obj)
                          / max(1.0, abs(ra)) < 1e-6)
                except ValueError:
                    pass
            if ok:
                correct += 1
            else:
                mismatches.append(name)
        else:
            mismatches.append(f"{name}:status{st}")
    implied_tflops = flops / elapsed / 1e12

    # BASELINE.json north-star metrics
    iters_per_s = total_iters / elapsed
    kkt_ms = float(np.median([
        1e3 * pc["seconds"] / max(pc["max_iters"], 1)
        for pc in per_class.values()]))

    # baseline: reference C single-core on the same set — the committed
    # bench_ref_times.json artifact; the binary is only built if names
    # are missing from it (rc=0 runs only count as valid timings)
    vs_baseline = 0.0
    base_ppm = None
    committed = {}
    if os.path.exists(REF_TIMES_COMMITTED):
        with open(REF_TIMES_COMMITTED) as fp:
            committed = json.load(fp)
    binary = (build_reference()
              if any(n not in committed for n in names_all) else None)
    ref_total, ref_valid, ref_failed = time_reference(binary, names_all)
    if ref_total > 0 and ref_valid:
        base_ppm = 60.0 * len(ref_valid) / ref_total
    # vs_baseline over the INTERSECTION: if some benched problems lack a
    # valid (rc=0) baseline row, the rate in the numerator is restricted
    # to the same problem set
    if base_ppm:
        ppm_valid = 60.0 * len(ref_valid) / elapsed
        vs_baseline = ppm_valid / base_ppm

    detail = {
        "classes": {class_tag(k): len(v) for k, v in classes.items()},
        "big_problems": [n for n, _ in big],
        "per_class_final_rep": per_class,
        "records_final_rep": [list(r) for r in records],
        "mismatches": mismatches,
        "rep_times_s": [round(t, 3) for t in rep_times],
        "excluded": sorted(excludes),
    }
    headline = {
        "metric": "netlib_problems_per_min",
        "value": round(ppm, 3),
        "unit": "problems/min",
        "vs_baseline": round(vs_baseline, 3),
        "n_problems": n_problems,
        "optimal": solved,
        "objective_match_1e6": correct,
        "n_mismatch": len(mismatches),
        "elapsed_s_median": round(elapsed, 3),
        "n_reps": len(rep_times),
        "total_ipm_iterations": total_iters,
        "ipm_iterations_per_s": round(iters_per_s, 1),
        "kkt_ms_per_chip": round(kkt_ms, 2),
        "implied_tflops": round(implied_tflops, 2),
        "compile_warmup_s": round(compile_s, 2),
        "script_wall_s": round(time.perf_counter() - t_script0, 1),
        "baseline_problems_per_min": round(base_ppm, 3) if base_ppm else None,
        "baseline_n_valid": len(ref_valid),
        "baseline_n_failed": ref_failed,
        "baseline_partial": len(ref_valid) != n_problems,
        "n_excluded": len(excludes),
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
    }
    # the detail file embeds the headline; stdout's LAST line carries only
    # the compact headline
    with open(DETAIL_PATH, "w") as fp:
        json.dump(dict(headline=headline, **detail), fp, indent=1)
    print(json.dumps(headline))
    return 0


if __name__ == "__main__":
    sys.exit(main())
