"""Distinct-geometry batch solving: dualize_distinct and the generalized
einsum path in solve_batched and solve_mixed (batched Qp/Gp/Qd), checked
against per-instance solves and the C++ float32 oracle.

This is the reference's own benchmark workload shape — one random
geometry per instance (testing/test_generator.c:997-998)."""

import numpy as np
import pytest


def _instances(B=5, M=6, N=16, seed=0):
    import jax.numpy as jnp
    from pqp_for_mpc_tpu import dualize
    from pqp_for_mpc_tpu.problem import PrimalQP

    rng = np.random.default_rng(seed)
    primals = []
    for _ in range(B):
        L = rng.standard_normal((M, M)).astype(np.float32)
        Qp = L @ L.T + M * np.eye(M, dtype=np.float32)
        primals.append(PrimalQP(
            Qp=jnp.asarray(Qp),
            Qp_inv=jnp.asarray(np.linalg.inv(Qp).astype(np.float32)),
            Fp=jnp.asarray(rng.standard_normal(M).astype(np.float32) * 3),
            Mp=jnp.asarray(np.float32(rng.standard_normal())),
            Gp=jnp.asarray(rng.integers(-1, 2, (N, M)).astype(np.float32)),
            Kp=jnp.asarray(rng.uniform(1.0, 8.0, N).astype(np.float32))))
    duals = [dualize(p) for p in primals]
    return primals, duals


def _stack(primals):
    import jax.numpy as jnp
    from pqp_for_mpc_tpu.problem import PrimalQP

    return PrimalQP(
        Qp=jnp.stack([p.Qp for p in primals]),
        Qp_inv=jnp.stack([p.Qp_inv for p in primals]),
        Fp=jnp.stack([p.Fp for p in primals], axis=1),
        Mp=jnp.stack([p.Mp for p in primals]),
        Gp=jnp.stack([p.Gp for p in primals]),
        Kp=jnp.stack([p.Kp for p in primals], axis=1))


def test_dualize_distinct_matches_per_instance():
    from pqp_for_mpc_tpu.dual import dualize_distinct

    primals, duals = _instances()
    dual_b = dualize_distinct(_stack(primals))
    for b, d in enumerate(duals):
        np.testing.assert_allclose(np.asarray(dual_b.Qd)[b],
                                   np.asarray(d.Qd), atol=1e-5)
        np.testing.assert_allclose(np.asarray(dual_b.Qdp_theta)[b],
                                   np.asarray(d.Qdp_theta), atol=1e-5)
        np.testing.assert_allclose(np.asarray(dual_b.Qdn_theta)[b],
                                   np.asarray(d.Qdn_theta), atol=1e-5)
        np.testing.assert_allclose(np.asarray(dual_b.Fd)[:, b],
                                   np.asarray(d.Fd), atol=1e-5)
        np.testing.assert_allclose(float(np.asarray(dual_b.Md)[b]),
                                   float(d.Md), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(dual_b.theta)[b],
                                   np.asarray(d.theta), atol=1e-5)


def test_solve_batched_full_distinct_geometry():
    """solve_batched handles fully batched geometry (Qp/Gp/Qd all
    leading-batch) directly — no vmap needed."""
    from pqp_for_mpc_tpu import SolverConfig, solve, solve_batched
    from pqp_for_mpc_tpu.dual import dualize_distinct

    primals, duals = _instances()
    cfg = SolverConfig(max_iters=20_000, check_every=4,
                       strict_weak_duality=False)
    refs = [solve(p, d, cfg=cfg) for p, d in zip(primals, duals)]
    primal_b = _stack(primals)
    dual_b = dualize_distinct(primal_b)
    res = solve_batched(primal_b, dual_b, cfg=cfg)
    assert bool(np.asarray(res.converged).all())
    for b, r in enumerate(refs):
        np.testing.assert_allclose(np.asarray(res.U)[:, b],
                                   np.asarray(r.U), rtol=5e-4, atol=5e-4)
        assert int(np.asarray(res.iters)[b]) == int(r.iters)


def _oracle(primal_b, b, cfg):
    from pqp_for_mpc_tpu import native
    return native.oracle_solve(
        np.asarray(primal_b.Qp_inv)[b], np.asarray(primal_b.Fp)[:, b],
        float(np.asarray(primal_b.Mp)[b]), np.asarray(primal_b.Gp)[b],
        np.asarray(primal_b.Kp)[:, b], erc=cfg.erc, eac=cfg.eac,
        eaj=cfg.eaj, erj=cfg.erj, theta_floor=cfg.theta_floor, y0=cfg.y0,
        max_iters=cfg.max_iters, strict=cfg.strict_weak_duality,
        gap_comp=cfg.gap_from_complementarity)


@pytest.mark.parametrize("gap_comp", [False, True])
def test_distinct_einsum_matches_oracle(gap_comp):
    """Every instance of the einsum path certifies where the C++ oracle
    does, on the same solution."""
    from pqp_for_mpc_tpu import SolverConfig, native, solve_batched
    from pqp_for_mpc_tpu.dual import dualize_distinct

    if not native.available():
        pytest.skip("native toolchain unavailable")
    primals, _ = _instances(B=4, seed=1)
    primal_b = _stack(primals)
    cfg = SolverConfig(max_iters=20_000, check_every=1,
                       strict_weak_duality=False,
                       gap_from_complementarity=gap_comp)
    res = solve_batched(primal_b, dualize_distinct(primal_b), cfg=cfg)
    for b in range(4):
        o = _oracle(primal_b, b, cfg)
        assert bool(np.asarray(res.converged)[b]) == o["converged"]
        np.testing.assert_allclose(np.asarray(res.U)[:, b], o["U"],
                                   rtol=1e-3, atol=1e-3)


def test_solve_mixed_distinct_matches_oracle():
    """solve_mixed on per-instance geometry (the bf16 einsum phase, then
    f32 certification) lands on the oracle's certified solutions."""
    import jax
    from pqp_for_mpc_tpu import SolverConfig, native, solve_mixed
    from pqp_for_mpc_tpu.dual import dualize_distinct

    if not native.available():
        pytest.skip("native toolchain unavailable")
    primals, _ = _instances(B=4, seed=2)
    primal_b = _stack(primals)
    cfg = SolverConfig(max_iters=20_000, check_every=8, accel_every=4,
                       strict_weak_duality=False,
                       gap_from_complementarity=True)
    res = jax.jit(lambda p, d: solve_mixed(p, d, cfg=cfg))(
        primal_b, dualize_distinct(primal_b))
    assert bool(np.asarray(res.converged).all())
    for b in range(4):
        o = _oracle(primal_b, b, cfg)
        assert o["converged"]
        np.testing.assert_allclose(np.asarray(res.U)[:, b], o["U"],
                                   rtol=1e-3, atol=2e-3)
