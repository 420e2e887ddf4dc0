"""chip_smoke.py on the CPU: its phases at tiny sizes, and main()'s refusal
to run without a GPU.  The full-size run is `python chip_smoke.py` on a
card."""

import json

import pytest

import chip_smoke as cs


@pytest.fixture(scope="module")
def clock():
    return cs.CompileClock()


@pytest.fixture(scope="module")
def refs():
    r = cs.References()
    yield r
    r.close()


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_phase_kernels():
    out = cs.phase_kernels(64, 128)
    assert set(out) == {"syrk_f32_s", "cholesky_f64_s", "matvec_f64_s",
                        "rmatvec_f64_s"}


def test_phase_lp_ipm(clock, refs, tmp_path):
    out = cs.phase_lp_ipm(20, 40, clock, refs, str(tmp_path))
    for method in ("hsd", "hsdls", "intpt"):
        assert out[method]["status"] == 0
        assert out[method]["iterations"] > 0
    assert abs(out["hsd_f64"] - out["highs_objective"]) <= 1e-6 * max(
        1.0, abs(out["highs_objective"]))


def test_phase_lp_simplex(clock, refs):
    out = cs.phase_lp_simplex(20, 40, clock, refs)
    assert set(out) == {"pd", "twophase"}


def test_phase_batch(clock, refs):
    out = cs.phase_batch(20, 40, 4, clock, refs)
    assert (out["status"] == 0).all() and len(out["objectives"]) == 4


def test_phase_sharded_lp(clock):
    out = cs.phase_sharded_lp(20, 40, 4, clock)
    assert out["sharded"] == pytest.approx(out["one_device"], rel=1e-9)


def test_phase_sharded_batch(clock):
    out = cs.phase_sharded_batch(20, 40, 8, 4, clock)
    assert len(out["sharded"]) == 8


def test_references_memoize(refs):
    assert refs.highs(12, 24, 3) is refs.highs(12, 24, 3)
    status, obj = refs.highs(12, 24, 3).result()
    assert status == 0 and obj == obj


def test_check_raises():
    with pytest.raises(cs.SmokeFailure, match="boom"):
        cs.check(False, "boom")


def test_run_cli_parses_output(tmp_path):
    from vanderbei_tpu.io.synthetic import random_lp
    import vanderbei_tpu as vt
    path = str(tmp_path / "t.mps")
    vt.write_lp(random_lp(10, 20, density=0.3, ub_frac=0.0, seed=1), path)
    res = cs._run_cli([path, "--out", str(tmp_path / "t.out")])
    assert res["status"] == 0 and res["iterations"] > 0
    assert json.loads(json.dumps(res)) == res
