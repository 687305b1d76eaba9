"""Mixed-precision (bf16 bulk + f32 refine) solve: solver.solve_mixed.

The certification always runs in float32 on the TRUE problem, so the
bar here is exact: solve_mixed must converge wherever solve_batched
does and land on the same U* (same tolerances, same four-part test).
The bf16 phase is a throughput device only (benchmarks/bench_mixed.py
times it against the f32 path).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def _example(example_data):
    from pqp_for_mpc_tpu.dual import dualize
    primal = example_data.assemble(Qp=example_data.qp())
    return primal, dualize(primal)


def _random_qp(N=96, M=32, B=4, seed=0):
    from pqp_for_mpc_tpu.dual import dualize
    from pqp_for_mpc_tpu.problem import PrimalQP

    rng = np.random.default_rng(seed)
    Q = rng.normal(0, 1, (M, M)).astype(np.float32)
    Qp = Q @ Q.T + M * np.eye(M, dtype=np.float32)
    primal = PrimalQP(
        Qp=jnp.asarray(Qp),
        Qp_inv=jnp.asarray(np.linalg.inv(Qp).astype(np.float32)),
        Fp=jnp.asarray(rng.normal(0, 3, (M, B)).astype(np.float32)),
        Mp=jnp.zeros((B,), jnp.float32),
        Gp=jnp.asarray(rng.normal(0, 1, (N, M)).astype(np.float32)),
        Kp=jnp.asarray(rng.uniform(1, 10, N).astype(np.float32)))
    return primal, dualize(primal)


def test_mixed_matches_f32_on_golden(example_data):
    from pqp_for_mpc_tpu import SolverConfig, solve_batched, solve_mixed

    primal, dual = _example(example_data)
    cfg = SolverConfig(max_iters=20000, check_every=8,
                       strict_weak_duality=False)
    r32 = solve_batched(primal, dual, cfg=cfg)
    rmx = solve_mixed(primal, dual, cfg=cfg)
    assert bool(np.asarray(rmx.converged).all())
    np.testing.assert_allclose(np.asarray(rmx.U), np.asarray(r32.U),
                               rtol=1e-4, atol=1e-4)
    assert int(np.asarray(rmx.iters)[0]) > 0


def test_mixed_with_accel_random_batch():
    from pqp_for_mpc_tpu import SolverConfig, solve_batched, solve_mixed

    primal, dual = _random_qp(B=4)
    cfg = SolverConfig(max_iters=50000, check_every=8, accel_every=4,
                       strict_weak_duality=False,
                       gap_from_complementarity=True)
    r32 = solve_batched(primal, dual, cfg=cfg)
    rmx = solve_mixed(primal, dual, cfg=cfg)
    assert np.asarray(rmx.converged).sum() == np.asarray(r32.converged).sum()
    both = np.asarray(rmx.converged) & np.asarray(r32.converged)
    assert both.any()
    np.testing.assert_allclose(np.asarray(rmx.U)[:, both],
                               np.asarray(r32.U)[:, both],
                               rtol=2e-3, atol=2e-3)


def test_mixed_under_jit():
    """The production calling convention (the eager path re-materializes
    the bf16 geometry per call; under jit it is compiled in once)."""
    from pqp_for_mpc_tpu import SolverConfig, solve_mixed

    primal, dual = _random_qp(B=2, seed=5)
    cfg = SolverConfig(max_iters=50000, check_every=8, accel_every=4,
                       strict_weak_duality=False,
                       gap_from_complementarity=True)
    run = jax.jit(lambda: solve_mixed(primal, dual, cfg=cfg))
    r = run()
    assert bool(np.asarray(r.converged).all()), r.stats()


def test_mixed_warm_start():
    from pqp_for_mpc_tpu import SolverConfig, solve_batched, solve_mixed

    primal, dual = _random_qp(B=3, seed=1)
    cfg = SolverConfig(max_iters=50000, check_every=8, accel_every=4,
                       strict_weak_duality=False,
                       gap_from_complementarity=True)
    r = solve_batched(primal, dual, cfg=cfg)
    rw = solve_mixed(primal, dual, Y0=jnp.maximum(r.Y, 0.01), cfg=cfg)
    assert bool(np.asarray(rw.converged).all())
    # warm-started from the solution: total iterations must be small
    assert int(np.asarray(rw.iters).max()) <= 64


def test_mixed_distinct_geometry_matches_f32():
    """Per-instance (3-D Qd) batches ride the same bf16 bulk phase —
    theta from each instance's OWN rounded rowsums."""
    from pqp_for_mpc_tpu import SolverConfig, solve_batched, solve_mixed
    from pqp_for_mpc_tpu.dual import dualize_distinct
    from pqp_for_mpc_tpu.problem import PrimalQP

    rng = np.random.default_rng(2)
    B, M, N = 3, 16, 48
    Qps = []
    for _ in range(B):
        Q = rng.normal(0, 1, (M, M)).astype(np.float32)
        Qps.append(Q @ Q.T + M * np.eye(M, dtype=np.float32))
    primal = PrimalQP(
        Qp=jnp.asarray(np.stack(Qps)),
        Qp_inv=jnp.asarray(np.stack([np.linalg.inv(q) for q in Qps])
                           .astype(np.float32)),
        Fp=jnp.asarray(rng.normal(0, 2, (M, B)).astype(np.float32)),
        Mp=jnp.zeros((B,), jnp.float32),
        Gp=jnp.asarray(rng.normal(0, 1, (B, N, M)).astype(np.float32)),
        Kp=jnp.asarray(rng.uniform(1, 5, (N, B)).astype(np.float32)))
    dual = dualize_distinct(primal)
    cfg = SolverConfig(max_iters=50000, check_every=8, accel_every=4,
                       strict_weak_duality=False,
                       gap_from_complementarity=True)
    r32 = solve_batched(primal, dual, cfg=cfg)
    rmx = solve_mixed(primal, dual, cfg=cfg)
    assert np.asarray(rmx.converged).sum() == np.asarray(r32.converged).sum()
    both = np.asarray(rmx.converged) & np.asarray(r32.converged)
    assert both.any()
    np.testing.assert_allclose(np.asarray(rmx.U)[:, both],
                               np.asarray(r32.U)[:, both],
                               rtol=2e-3, atol=2e-3)


def test_mixed_consistent_split_invariants():
    """The split construction solve_mixed relies on: one rounding of Qd,
    exact elementwise split, theta dominating the ROUNDED negative
    rowsums — the invariants whose violation made the naive two-sided
    rounding diverge (Y -> 3e9, see solve_mixed docstring)."""
    _, dual = _random_qp(seed=3)
    bf16 = jnp.bfloat16
    Qd_bf = dual.Qd.astype(bf16)
    Qdn = jnp.maximum(-Qd_bf, 0)
    Qdp = jnp.maximum(Qd_bf, 0)
    # exact split of the rounded matrix: difference reproduces it exactly
    np.testing.assert_array_equal(
        np.asarray((Qdp - Qdn).astype(jnp.float32)),
        np.asarray(Qd_bf.astype(jnp.float32)))
    theta = jnp.maximum(jnp.sum(Qdn.astype(jnp.float32), axis=1), 5.0)
    assert bool((theta >= jnp.diagonal(Qdn).astype(jnp.float32)).all())


def test_mixed_nan_lane_recovers_via_cold_reset():
    """A lane whose phase-1 iterate is non-finite must be reset to the
    cold start before the f32 refine (NaN is absorbing under the
    multiplicative update) — code-review r4 finding."""
    from pqp_for_mpc_tpu import SolverConfig, solve_mixed

    primal, dual = _random_qp(B=3, seed=4)
    cfg = SolverConfig(max_iters=50000, check_every=8, accel_every=4,
                       strict_weak_duality=False,
                       gap_from_complementarity=True)
    N = dual.n_con
    Y0 = jnp.full((N, 3), 1000.0, jnp.float32).at[:, 1].set(jnp.nan)
    r = solve_mixed(primal, dual, Y0=Y0, cfg=cfg)
    assert bool(np.asarray(r.converged).all()), r.stats()
    assert np.isfinite(np.asarray(r.U)).all()


def test_bf16_phase_dual_objective_monotone():
    """The consistent construction's load-bearing property: phase-1
    updates must not increase the BF16 problem's dual objective
    f(Y) = 1/2 Y'Qd_bf Y + Fd'Y (this is exactly what independent
    rounding of the two splits destroyed — Y diverged to 3e9)."""
    _, dual = _random_qp(N=128, M=48, B=4, seed=7)
    bf16 = jnp.bfloat16
    Qd_bf = dual.Qd.astype(bf16)
    Qdn = jnp.maximum(-Qd_bf, 0)
    Qdp = jnp.maximum(Qd_bf, 0)
    theta = jnp.maximum(
        jnp.sum(Qdn.astype(jnp.float32), axis=1), 5.0)[:, None]
    Fd = dual.Fd[:, None] if dual.Fd.ndim == 1 else dual.Fd
    Fdn = jnp.maximum(-Fd, 0.0)
    Fdp = jnp.maximum(Fd, 0.0)

    def f_bf(Y):
        QdY = jnp.dot(Qd_bf, Y.astype(bf16),
                      preferred_element_type=jnp.float32)
        return np.asarray(0.5 * jnp.sum(Y * QdY, axis=0)
                          + jnp.sum(Fd * Y, axis=0))

    rng = np.random.default_rng(1)
    Y = jnp.asarray(rng.uniform(0.5, 1000.0, (128, 4)).astype(np.float32))
    prev = f_bf(Y)
    for _ in range(60):
        yb = Y.astype(bf16)
        num = jnp.dot(Qdn, yb, preferred_element_type=jnp.float32) \
            + theta * Y + Fdn
        den = jnp.dot(Qdp, yb, preferred_element_type=jnp.float32) \
            + theta * Y + Fdp
        Y = (num / den) * Y
        cur = f_bf(Y)
        # small slack: the Y->bf16 cast inside the matvec adds noise at
        # the rounding scale; the OBJECTIVE-scale trend must be down
        assert (cur <= prev + 1e-3 * np.abs(prev) + 1e-3).all(), \
            (cur, prev)
        prev = cur
    assert np.isfinite(np.asarray(Y)).all()
    assert float(jnp.abs(Y).max()) < 1e6   # no divergence
