"""Algorithmic property tests (SURVEY.md §4's implied test plan: gap
decrease, nonnegativity invariant, feasibility at termination)."""

import numpy as np
import pytest


def _random_problem(M, N, B, seed):
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


def _dual_cost(dual, Y):
    Qd = np.asarray(dual.Qd)
    Fd = np.asarray(dual.Fd)
    Yn = np.asarray(Y, np.float64)
    return 0.5 * np.einsum("ib,ij,jb->b", Yn, Qd.astype(np.float64), Yn) \
        + (Fd.astype(np.float64)[:, :, ] * Yn).sum(0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multiplicative_update_decreases_dual_cost(seed):
    """Di Cairano-Brand guarantee: each update does not increase the dual
    objective (checked in float64 against float32 iterates)."""
    import jax.numpy as jnp
    from pqp_for_mpc_tpu.solver import pqp_update

    primal, dual = _random_problem(10, 24, 8, seed)
    Y = jnp.full((24, 8), 5.0, jnp.float32)
    prev = _dual_cost(dual, Y)
    for _ in range(50):
        Y = pqp_update(dual, Y, den_eps=1e-30)
        cur = _dual_cost(dual, Y)
        assert np.all(cur <= prev + 1e-3 * np.maximum(1.0, np.abs(prev)))
        prev = cur


@pytest.mark.parametrize("seed", [0, 3])
def test_iterates_stay_nonnegative(seed):
    import jax.numpy as jnp
    from pqp_for_mpc_tpu.solver import accel_step, pqp_update

    primal, dual = _random_problem(8, 20, 4, seed)
    Y = jnp.full((20, 4), 2.0, jnp.float32)
    done = jnp.zeros(4, bool)
    for i in range(40):
        Y = pqp_update(dual, Y, den_eps=1e-30)
        if i % 4 == 3:
            Y = accel_step(dual, Y, done)
        assert np.all(np.asarray(Y) >= 0.0)


def test_feasible_at_termination():
    from pqp_for_mpc_tpu import SolverConfig, solve_batched

    primal, dual = _random_problem(10, 24, 16, 5)
    cfg = SolverConfig(max_iters=50_000, check_every=4,
                       strict_weak_duality=False)
    res = solve_batched(primal, dual, cfg=cfg)
    conv = np.asarray(res.converged)
    assert np.asarray(res.feasible)[conv].all()
    # converged lanes satisfy Gp U <= Kp + slack explicitly
    GpU = np.asarray(primal.Gp) @ np.asarray(res.U)
    slack = np.asarray(primal.Kp) + np.maximum(
        cfg.erc * np.asarray(primal.Kp), cfg.eac)
    assert np.all(GpU[:, conv] <= slack[:, None] + 1e-7)


def test_accel_never_increases_dual_cost():
    """The safeguard makes the acceleration step monotone by
    construction; verify over many random states."""
    import jax.numpy as jnp
    from pqp_for_mpc_tpu.solver import accel_step

    primal, dual = _random_problem(10, 24, 8, 7)
    rng = np.random.default_rng(11)
    done = jnp.zeros(8, bool)
    for _ in range(10):
        Y = jnp.asarray(np.abs(rng.standard_normal((24, 8))).astype(
            np.float32) * rng.uniform(0.01, 100))
        before = _dual_cost(dual, Y)
        after = _dual_cost(dual, accel_step(dual, Y, done))
        assert np.all(after <= before + 1e-2 * np.maximum(1.0,
                                                          np.abs(before)))


@pytest.mark.parametrize("seed", [0, 1])
def test_complementarity_gap_identity(seed):
    """Jp(U(Y)) + Jd(Y) == Y'(Qd Y + Fd) for the recovered primal — the
    identity behind SolverConfig.gap_from_complementarity, checked in
    float64 against the float32 data (the two float32 estimates differ;
    the float64 ground truths must agree)."""
    from pqp_for_mpc_tpu.solver import complementarity_gap, recover_U

    primal, dual = _random_problem(10, 24, 4, seed)
    rng = np.random.default_rng(seed + 100)
    Y = np.abs(rng.standard_normal((24, 4))).astype(np.float32)

    # float64 ground truth of both sides
    Qp = np.asarray(primal.Qp, np.float64)
    Fp = np.asarray(primal.Fp, np.float64)
    Mp = np.asarray(primal.Mp, np.float64)
    Gp = np.asarray(primal.Gp, np.float64)
    Qd = np.asarray(dual.Qd, np.float64)
    Fd = np.asarray(dual.Fd, np.float64)
    Md = np.asarray(dual.Md, np.float64)
    Y64 = Y.astype(np.float64)
    U = -np.linalg.solve(Qp, Fp + Gp.T @ Y64)
    Jp = 0.5 * np.einsum("ib,ij,jb->b", U, Qp, U) + (Fp * U).sum(0) + Mp / 2
    Jd = 0.5 * np.einsum("ib,ij,jb->b", Y64, Qd, Y64) \
        + (Fd * Y64).sum(0) + Md / 2
    lhs = Jp + Jd
    rhs = (Y64 * (Qd @ Y64 + Fd)).sum(0)
    # Md is itself built from float32 Qd/Fp data, so the float64
    # identity holds to float32 data accuracy
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4, atol=1e-3)

    # and the float32 implementation computes the same quantity
    got = np.asarray(complementarity_gap(dual, Y))
    np.testing.assert_allclose(got, rhs, rtol=1e-3, atol=1e-2)
    # sanity: recover_U matches the float64 recovery
    np.testing.assert_allclose(np.asarray(recover_U(primal, Y)), U,
                               rtol=1e-3, atol=1e-3)


def test_complementarity_mode_solves_reference_example():
    """gap_from_complementarity=True reaches the same U* on the
    example-shaped problem (it changes the certification estimator, not
    the iterate trajectory)."""
    import dataclasses
    from pqp_for_mpc_tpu import SolverConfig, solve
    from pqp_for_mpc_tpu.models.example import example_problem

    primal = example_problem()
    cfg = SolverConfig(max_iters=5000)
    ref = solve(primal, cfg=cfg)
    res = solve(primal, cfg=dataclasses.replace(
        cfg, gap_from_complementarity=True))
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.U), np.asarray(ref.U),
                               rtol=1e-4, atol=1e-4)


def test_no_splits_dual_matches_materialized():
    """dualize(materialize_splits=False): half the geometry memory, the
    same certified solution — the splits are computed on the fly inside
    the update's dots."""
    from pqp_for_mpc_tpu import SolverConfig, dualize, solve_batched
    from pqp_for_mpc_tpu.models.example import example_problem

    primal = example_problem(8)
    cfg = SolverConfig(max_iters=5000, check_every=8, accel_every=4,
                       y0=0.01, eaj=1e-4, erj=1e-4, erc=1e-4, eac=1e-4,
                       strict_weak_duality=False,
                       gap_from_complementarity=True)
    d_mat = dualize(primal, theta_floor=cfg.theta_floor)
    d_fly = dualize(primal, theta_floor=cfg.theta_floor,
                    materialize_splits=False)
    assert d_fly.Qdn_theta is None and d_fly.Qdp_theta is None
    a = solve_batched(primal, d_mat, cfg=cfg)
    b = solve_batched(primal, d_fly, cfg=cfg)
    assert bool(np.asarray(a.converged).all())
    assert bool(np.asarray(b.converged).all())
    # the theta term accumulates in a different place (inside the dot
    # vs a separate add) so the programs differ at float-noise scale;
    # the certified solutions agree to certificate scale
    np.testing.assert_allclose(np.asarray(a.U), np.asarray(b.U),
                               rtol=1e-3, atol=2e-3)


def test_no_splits_dual_guards_kernel_paths():
    """The whole-solve kernel, which needs materialized splits, says so."""
    from pqp_for_mpc_tpu import dualize
    from pqp_for_mpc_tpu.models.example import example_problem
    from pqp_for_mpc_tpu.ops.solve_kernel import solve_fused

    primal = example_problem()
    d_fly = dualize(primal, materialize_splits=False)
    with pytest.raises(ValueError, match="materialize_splits=True"):
        solve_fused(primal, d_fly, interpret=True)
