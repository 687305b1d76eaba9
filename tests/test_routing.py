"""Automatic solve-engine routing.

route_solve picks the whole-solve GPU kernel only in the regime it was
measured faster on the H100 and XLA everywhere else; solve_auto is a
drop-in for solve_batched — same results where the route lands on the
XLA engine (this CPU test host), retry_cold included.
"""

import numpy as np
import pytest


def _cfg(**kw):
    from pqp_for_mpc_tpu import SolverConfig
    args = dict(max_iters=20_000, check_every=8, accel_every=4, y0=0.01,
                eaj=1e-4, erj=1e-4, erc=1e-4, eac=1e-4,
                strict_weak_duality=False, gap_from_complementarity=True)
    args.update(kw)
    return SolverConfig(**args)


# ---------------------------------------------------------------- decisions

def test_route_cpu_always_xla():
    from pqp_for_mpc_tpu.routing import route_solve
    for n, b, distinct in [(28, 1, False), (28, 1 << 20, False),
                           (4096, 128, False), (2048, 8, True)]:
        assert route_solve(n, b, distinct, _cfg(accel_every=0),
                           platform="cpu") == "xla"


_KERNEL_CFG = dict(accel_every=0)


@pytest.mark.parametrize("n,b,kw,warm,distinct,platform,want", [
    (28, 1 << 20, {}, False, False, "gpu", "fused"),     # measured 1.89x
    (64, 1 << 18, {}, False, False, "gpu", "fused"),     # measured 1.23x
    (17, 1 << 18, {}, False, False, "gpu", "fused"),
    (16, 1 << 20, {}, False, False, "gpu", "xla"),       # unmeasured N
    (65, 1 << 20, {}, False, False, "gpu", "xla"),       # beyond the kernel
    (128, 1 << 18, {}, False, False, "gpu", "xla"),      # measured slower
    (28, (1 << 18) - 1, {}, False, False, "gpu", "xla"),  # unmeasured B
    (28, 1 << 20, {}, True, False, "gpu", "xla"),        # warm start
    (28, 1 << 20, {}, False, True, "gpu", "xla"),        # distinct
    (28, 1 << 20, {"accel_every": 4}, False, False, "gpu", "xla"),
    (28, 1 << 20, {"feas_from_dual_gradient": True}, False, False, "gpu",
     "xla"),
    (28, 1 << 20, {}, False, False, "cpu", "xla"),
])
def test_route_gpu_map(n, b, kw, warm, distinct, platform, want):
    from pqp_for_mpc_tpu.routing import route_solve
    cfg = _cfg(**{**_KERNEL_CFG, **kw})
    assert route_solve(n, b, distinct, cfg, platform=platform,
                       warm=warm) == want


def test_route_rejects_unknown_engine():
    from pqp_for_mpc_tpu.dual import dualize
    from pqp_for_mpc_tpu.models.example import example_problem
    from pqp_for_mpc_tpu.routing import solve_auto

    primal = example_problem()
    dual = dualize(primal)
    with pytest.raises(ValueError, match="unknown engine"):
        solve_auto(primal, dual, engine="cuda")


def test_auto_backend_by_horizon():
    """backend="auto": condensed below the measured n_con crossover
    (CONTROLLER_BENCH_r4: condensed 2.3-4x faster at H<=128), stage-wise
    beyond; condensed-only features pin condensed."""
    import dataclasses
    from pqp_for_mpc_tpu.models import (MPCController, MPCSpec,
                                        auto_backend, condensed_n_con,
                                        double_integrator)

    def spec(H, **kw):
        args = dict(plant=double_integrator(), horizon=H,
                    Qy=np.eye(1, dtype=np.float32),
                    R=0.05 * np.eye(1, dtype=np.float32),
                    r=np.zeros(1, np.float32),
                    u_min=np.array([-1.0], np.float32),
                    u_max=np.array([1.0], np.float32),
                    du_max=np.array([0.5], np.float32))
        args.update(kw)
        return MPCSpec(**args)

    assert condensed_n_con(spec(16)) == 64
    assert auto_backend(spec(16)) == "condensed"
    assert auto_backend(spec(128)) == "condensed"
    # 4*512 = 2048 > crossover
    assert auto_backend(spec(512)) == "stagewise"
    # output bounds double the row count per stage: 6*H
    s_y = spec(256, y_max=np.array([1.0], np.float32))
    assert condensed_n_con(s_y) == 4 * 256 + 2 * 256
    assert auto_backend(s_y) == "stagewise"
    # condensed-only features pin the condensed backend at any horizon
    assert auto_backend(spec(512, moves=8)) == "condensed"
    # the controller accepts "auto" and resolves it (the H=512 resolve
    # is asserted through the pure function above — instantiating it
    # would pay the full O(H^2) stage-wise build in a unit test)
    c = MPCController(spec(16), backend="auto")
    assert c.backend == "condensed"


# ---------------------------------------------------------------- behavior

def _example_problem():
    from pqp_for_mpc_tpu.dual import dualize
    from pqp_for_mpc_tpu.models.example import example_problem

    primal = example_problem(16)
    return primal, dualize(primal)


def test_solve_auto_matches_solve_batched_on_cpu():
    from pqp_for_mpc_tpu import solve_batched
    from pqp_for_mpc_tpu.routing import solve_auto

    primal, dual = _example_problem()
    cfg = _cfg()
    a = solve_auto(primal, dual, cfg=cfg)
    b = solve_batched(primal, dual, cfg=cfg)
    assert bool(np.asarray(a.converged).all())
    np.testing.assert_array_equal(np.asarray(a.U), np.asarray(b.U))
    np.testing.assert_array_equal(np.asarray(a.iters), np.asarray(b.iters))


def test_solve_auto_forced_mixed_engine_certifies():
    """Engine override: the mixed path still certifies on the true f32
    problem (here on CPU, where auto routing would pick xla)."""
    import jax
    from pqp_for_mpc_tpu import solve_batched
    from pqp_for_mpc_tpu.routing import solve_auto

    primal, dual = _example_problem()
    cfg = _cfg()
    run = jax.jit(lambda p, d: solve_auto(p, d, cfg=cfg, engine="mixed"))
    a = run(primal, dual)
    assert bool(np.asarray(a.converged).all())
    b = solve_batched(primal, dual, cfg=cfg)
    np.testing.assert_allclose(np.asarray(a.U), np.asarray(b.U),
                               rtol=1e-3, atol=2e-3)


def test_solve_auto_retry_cold_rescues_poisoned_warm_start():
    """retry_cold composes with routing: a hostile all-zeros warm start
    (the multiplicative update's absorbing state) is rescued by the
    in-dispatch cold retry on every engine path."""
    import jax.numpy as jnp
    from pqp_for_mpc_tpu.routing import solve_auto

    primal, dual = _example_problem()
    cfg = _cfg()
    N, B = dual.n_con, 16
    Y0 = jnp.zeros((N, B), jnp.float32)
    res = solve_auto(primal, dual, Y0=Y0, cfg=cfg, retry_cold=True)
    assert bool(np.asarray(res.converged).all()), res.stats()
    # and through a forced non-default engine (generic retry wrapper)
    res2 = solve_auto(primal, dual, Y0=Y0, cfg=cfg, retry_cold=True,
                      engine="mixed")
    assert bool(np.asarray(res2.converged).all())


def test_forced_kernel_engine_rejected_off_gpu():
    """Forcing the GPU kernel engine on another backend raises a clear
    error instead of a Triton lowering stack trace."""
    from pqp_for_mpc_tpu.dual import dualize
    from pqp_for_mpc_tpu.models.example import example_problem
    from pqp_for_mpc_tpu.routing import solve_auto

    primal = example_problem()
    dual = dualize(primal)
    with pytest.raises(ValueError, match="GPU kernel"):
        solve_auto(primal, dual, engine="fused")


def test_auto_downgrades_on_split_free_dual(monkeypatch):
    """Auto routing never errors on a split-free dual: where the GPU
    route would pick the kernel (which holds the materialized splits)
    it takes the XLA engine instead."""
    from pqp_for_mpc_tpu import dualize, routing, solve_batched
    from pqp_for_mpc_tpu.models.example import example_problem

    primal = example_problem(16)
    d_fly = dualize(primal, materialize_splits=False)
    cfg = _cfg(accel_every=0)
    monkeypatch.setattr(routing.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(routing, "FUSED_MIN_BATCH", 1)
    assert routing.route_solve(d_fly.n_con, 16, False, cfg) == "fused"
    res = routing.solve_auto(primal, d_fly, cfg=cfg)
    assert bool(np.asarray(res.converged).all())
    ref = solve_batched(primal, d_fly, cfg=cfg)
    np.testing.assert_array_equal(np.asarray(res.U), np.asarray(ref.U))
