"""Regression tests for earlier review findings: diverged-lane iteration
stamping, strict-JSON serve replies, significant-digit export, warm-start
batch validation, and the single-instance guard on solve()."""

import json

import numpy as np
import pytest


def _problem(B=4, seed=0, M=6, N=14):
    import jax.numpy as jnp
    from pqp_for_mpc_tpu import dualize
    from pqp_for_mpc_tpu.problem import PrimalQP

    rng = np.random.default_rng(seed)
    L = rng.standard_normal((M, M)).astype(np.float32)
    Qp = L @ L.T + M * np.eye(M, dtype=np.float32)
    primal = PrimalQP(
        Qp=jnp.asarray(Qp),
        Qp_inv=jnp.asarray(np.linalg.inv(Qp).astype(np.float32)),
        Fp=jnp.asarray(rng.standard_normal((M, B)).astype(np.float32) * 5),
        Mp=jnp.asarray(rng.standard_normal(B).astype(np.float32)),
        Gp=jnp.asarray(rng.integers(-1, 2, (N, M)).astype(np.float32)),
        Kp=jnp.asarray(rng.uniform(1.0, 10.0, N).astype(np.float32)))
    return primal, dualize(primal)


def test_diverged_lane_reports_freeze_iteration():
    """ADVICE #1: a diverged lane must report the iteration at which it
    was frozen (>= 1), not a never-stamped 0 that skews stats()."""
    import jax.numpy as jnp
    from pqp_for_mpc_tpu import SolverConfig, solve_batched

    primal, dual = _problem(B=4)
    N = dual.n_con
    Y0 = jnp.full((N, 4), 1.0, jnp.float32)
    Y0 = Y0.at[0, 2].set(jnp.nan)
    res = solve_batched(
        primal, dual, Y0=Y0,
        cfg=SolverConfig(max_iters=20_000, check_every=4,
                         strict_weak_duality=False))
    iters = np.asarray(res.iters)
    assert bool(np.asarray(res.diverged)[2])
    assert iters[2] >= 1, "diverged lane iters never stamped"
    assert iters[2] <= 5


def test_json_sanitize_nonfinite():
    """ADVICE #2: serve replies must be strict JSON even for diverged
    solves — non-finite floats map to null."""
    from pqp_for_mpc_tpu.cli import _json_sanitize

    out = {"a": float("nan"), "b": [1.0, float("inf"), {"c": -float("inf")}],
           "d": 3, "e": "x"}
    s = json.dumps(_json_sanitize(out), allow_nan=False)
    back = json.loads(s)
    assert back["a"] is None
    assert back["b"][1] is None
    assert back["b"][2]["c"] is None
    assert back["d"] == 3 and back["e"] == "x"


def test_write_matrix_file_preserves_tiny_values(tmp_path):
    """ADVICE #3: %.8g keeps sub-1e-6 coefficients (stiff plants) instead
    of flushing them to 0.000000."""
    from pqp_for_mpc_tpu.io.example_loader import (read_matrix_file,
                                                   write_matrix_file)

    m = np.array([[3e-9, 1.5], [-2.5e-7, 304.25]], dtype=np.float32)
    p = str(tmp_path / "m.txt")
    write_matrix_file(p, m)
    back = read_matrix_file(p, 2, 2)
    np.testing.assert_allclose(back, m, rtol=1e-6)
    assert back[0, 0] != 0.0 and back[1, 0] != 0.0


def test_solve_fused_warm_start_batch_mismatch():
    """ADVICE #4: mismatched warm-start batch raises a clear ValueError
    instead of an opaque Pallas shape error."""
    import jax.numpy as jnp
    from pqp_for_mpc_tpu.ops.solve_kernel import solve_fused

    primal, dual = _problem(B=4)
    N = dual.n_con
    bad = jnp.ones((N, 3), jnp.float32)
    with pytest.raises(ValueError, match="warm start batch"):
        solve_fused(primal, dual, Y0=bad)


def test_solve_rejects_batched_input():
    """VERDICT weak #4: solve() must reject batched primals instead of
    silently returning lane 0."""
    from pqp_for_mpc_tpu import solve

    primal, _ = _problem(B=3)
    with pytest.raises(ValueError, match="solve_batched"):
        solve(primal)
