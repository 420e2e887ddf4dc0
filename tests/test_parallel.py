"""Batching + mesh tests on the 8-virtual-device CPU backend, on seeded
generated LPs checked against scipy's HiGHS."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vanderbei_tpu.core.status import Status
from vanderbei_tpu.io.synthetic import highs_reference, random_lp
from vanderbei_tpu.parallel.batch import (
    group_by_class, stack_class, solve_batch_hsd, shard_batch)
from vanderbei_tpu.parallel.mesh import make_mesh


def _lps(seeds, m=20, n=40, ub_frac=0.0):
    return [random_lp(m, n, density=0.2, ub_frac=ub_frac, seed=s)
            for s in seeds]


def _highs(lps):
    out = []
    for lp in lps:
        st, obj = highs_reference(lp)
        assert st == int(Status.OPTIMAL)
        out.append(obj)
    return out


def test_devices_virtualized():
    assert len(jax.devices()) == 8


def test_group_and_stack():
    lps = _lps([0, 1, 2])
    classes, aborted = group_by_class(lps, granularity=128)
    assert not aborted
    # all three fit one (128, 128) class
    assert list(classes.keys()) == [(128, 128)]
    entries = classes[(128, 128)]
    A, b, c = stack_class(entries, 128, 128)
    assert A.shape == (3, 128, 128)
    # padding rows benign: b = 1 beyond canonical m
    m0 = entries[0][1].m
    np.testing.assert_allclose(b[0, m0:], 1.0)


def test_batched_hsd_matches_golden():
    lps = _lps([3, 4, 5])
    golden = _highs(lps)
    classes, _ = group_by_class(lps, granularity=128)
    entries = classes[(128, 128)]
    A, b, c = stack_class(entries, 128, 128)
    st, x, y, w, z, it = solve_batch_hsd(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))
    st = np.asarray(st)
    assert (st == int(Status.OPTIMAL)).all(), st
    for k, (idx, canon) in enumerate(entries):
        obj_canon = float(np.asarray(c[k]) @ np.asarray(x[k])) + canon.f
        sign = 1.0 if canon.maximize else -1.0
        g = golden[idx]
        assert abs(sign * obj_canon - g) / max(1, abs(g)) < 1e-6


def test_sharded_batch_runs():
    mesh = make_mesh(8, model_parallel=2)
    B = 8
    rng = np.random.default_rng(0)
    m, n = 16, 32
    A = rng.normal(size=(B, m, n))
    x0 = rng.uniform(1, 2, size=(B, n))
    b = np.einsum("bmn,bn->bm", A, x0) + 1.0
    c = -rng.uniform(0.1, 1.0, size=(B, n))
    A, b, c = shard_batch([A, b, c], mesh, model_axis_dims=(2, None, 1))
    st, x, y, w, z, it = solve_batch_hsd(A, b, c, max_iter=50)
    assert x.shape == (B, n)
    assert bool(jnp.all(jnp.isfinite(x)))


def test_dryrun_multichip():
    import __graft_entry__ as g
    g.dryrun_multichip(8)


def test_sharded_kkt_solve_matches_dense():
    """Column-sharded normal-equations solve == single-device solve."""
    from jax.sharding import Mesh
    from vanderbei_tpu.parallel.distributed import (
        sharded_kkt_solve, place_column_sharded)
    devices = np.array(jax.devices()[:8]).reshape(1, 8)
    mesh = Mesh(devices, ("batch", "model"))
    rng = np.random.default_rng(0)
    m, n = 24, 64                     # n sharded 8-way
    A = rng.normal(size=(m, n))
    D = rng.uniform(0.5, 2.0, n)
    E = rng.uniform(0.5, 2.0, m)
    ry = rng.normal(size=m)
    rx = rng.normal(size=n)
    K = np.block([[-np.diag(E), A], [A.T, np.diag(D)]])
    ref = np.linalg.solve(K, np.concatenate([ry, rx]))

    As, Ds, rxs = place_column_sharded(
        jnp.asarray(A), jnp.asarray(D), jnp.asarray(rx), mesh)
    dy, dx = jax.jit(
        lambda a, e, d, y, x: sharded_kkt_solve(a, e, d, y, x, mesh)
    )(As, jnp.asarray(E), Ds, jnp.asarray(ry), rxs)
    np.testing.assert_allclose(np.asarray(dy), ref[:m], rtol=1e-8)
    np.testing.assert_allclose(np.asarray(dx), ref[m:], rtol=1e-8)


def test_batched_pd_matches_golden():
    from vanderbei_tpu.parallel.batch import solve_batch_pd
    lps = _lps([6, 7, 8])
    golden = _highs(lps)
    classes, _ = group_by_class(lps, granularity=128)
    entries = classes[(128, 128)]
    A, b, c = stack_class(entries, 128, 128)
    st, x, y, w, z, it = solve_batch_pd(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), max_iter=5000)
    st = np.asarray(st)
    assert (st == int(Status.OPTIMAL)).all(), st
    for k, (idx, canon) in enumerate(entries):
        obj_canon = float(np.asarray(c[k]) @ np.asarray(x[k])) + canon.f
        sign = 1.0 if canon.maximize else -1.0
        g = golden[idx]
        assert abs(sign * obj_canon - g) / max(1, abs(g)) < 1e-6


def test_full_mesh_solve_equals_single_device():
    """A complete batched class solved to convergence under the
    ("batch", "model") mesh must equal the single-device solve — same
    statuses, same iteration counts, objectives equal to 1e-10.

    (GSPMD may reassociate the psum reductions, so exact bitwise equality
    is not guaranteed; 1e-10 on a converged optimum is.)"""
    lps = _lps([9, 10, 11, 12])
    golden = _highs(lps)
    classes, _ = group_by_class(lps, granularity=128)
    (key, entries), = classes.items()
    A, b, c = stack_class(entries, *key)

    single = solve_batch_hsd(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))

    mesh = make_mesh(8, model_parallel=2)
    As, bs, cs = shard_batch([A, b, c], mesh, model_axis_dims=(2, None, 1))
    sharded = solve_batch_hsd(As, bs, cs)

    st_s, x_s, _, _, _, it_s = [np.asarray(v) for v in single]
    st_m, x_m, _, _, _, it_m = [np.asarray(v) for v in sharded]
    assert (st_s == int(Status.OPTIMAL)).all()
    np.testing.assert_array_equal(st_s, st_m)
    for k, (idx, canon) in enumerate(entries):
        obj_s = canon.obj_scale * float(c[k] @ x_s[k]) + canon.f
        obj_m = canon.obj_scale * float(c[k] @ x_m[k]) + canon.f
        assert abs(obj_m - obj_s) <= 1e-10 * max(1.0, abs(obj_s)), idx
        sign = 1.0 if canon.maximize else -1.0
        g = golden[idx]
        assert abs(sign * obj_m - g) / max(1, abs(g)) < 1e-6


def test_batched_hsd_structured_ub_tail():
    """Problems with upper-bound tails batched through the structured
    (UbTail) class path must match their HiGHS optima."""
    from vanderbei_tpu.parallel.batch import stack_class_structured
    lps = _lps([13, 14, 15], ub_frac=0.3)     # all carry ub-row tails
    golden = _highs(lps)
    classes, aborted = group_by_class(lps, granularity=128,
                                      use_ub_structure=True)
    assert not aborted
    skeys = [k for k in classes if k[0] == "s"]
    assert skeys, f"no structured class formed: {list(classes)}"
    solved = {}
    for key in skeys:
        _, M1, N, K = key
        entries = classes[key]
        A1, b, c, ub = stack_class_structured(entries, M1, N, K)
        st, x, y, w, z, it = solve_batch_hsd(
            jnp.asarray(A1), jnp.asarray(b), jnp.asarray(c),
            ub=jax.tree.map(jnp.asarray, ub))
        st = np.asarray(st)
        assert (st == int(Status.OPTIMAL)).all(), (key, st)
        for j, (idx, canon) in enumerate(entries):
            obj_canon = canon.obj_scale * float(np.asarray(c[j]) @ np.asarray(x[j])) + canon.f
            sign = 1.0 if canon.maximize else -1.0
            solved[idx] = sign * obj_canon
    assert sorted(solved) == [0, 1, 2]
    for idx, obj in solved.items():
        g = golden[idx]
        assert abs(obj - g) / max(1, abs(g)) < 1e-6, (idx, obj, g)


def test_tp_product_path_equals_single_device():
    """solve(lp, mesh=...) — the tensor-parallel PRODUCT path: one wide LP
    with A column-sharded 8 ways through the same registry/HSD code, equal
    to the single-device solve."""
    import vanderbei_tpu as vt
    from vanderbei_tpu.core.config import SolverConfig

    # wide, the TP-profitable shape; upper bounds take the UbTail path
    lp = random_lp(30, 300, density=0.2, ub_frac=0.25, seed=16)
    cfg = SolverConfig()
    ref = vt.solve(lp, method="hsd", config=cfg)
    mesh = make_mesh(8, model_parallel=8)
    tp = vt.solve(lp, method="hsd", config=cfg, mesh=mesh)
    assert ref.status == tp.status == int(Status.OPTIMAL)
    assert abs(tp.primal_obj - ref.primal_obj) <= 1e-10 * max(
        1.0, abs(ref.primal_obj))
    # GSPMD reassociates the psum reductions, so the iterate paths differ
    # in the last bits; the solutions agree to solver tolerance, not
    # machine epsilon
    np.testing.assert_allclose(tp.x, ref.x, rtol=1e-5, atol=1e-6)
    _, golden = highs_reference(lp)
    assert abs(tp.primal_obj - golden) / max(1, abs(golden)) < 1e-6


def test_tp_mesh_rejects_simplex():
    import vanderbei_tpu as vt
    lp = _lps([17])[0]
    mesh = make_mesh(8, model_parallel=8)
    with pytest.raises(ValueError, match="hsd family"):
        vt.solve(lp, method="pd", mesh=mesh)
