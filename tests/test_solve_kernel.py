"""The whole-solve GPU kernel (ops/solve_kernel.py) against solve_batched.

On the CPU the kernel runs in the Pallas interpreter
(``interpret=True``); the one ``gpu``-marked test compiles it for the
card.  Both engines run the same check-then-updates loop, so they must
certify the same lanes at iteration counts equal up to the check cadence
and land on the same solution.
"""

import numpy as np
import pytest


def _problem(N, B, seed=0):
    """The example-shaped thermal problem with N/4 heaters (N = 4*M)."""
    from pqp_for_mpc_tpu import dualize
    from pqp_for_mpc_tpu.models.example import example_problem

    primal = example_problem(B, seed, n_heaters=N // 4)
    return primal, dualize(primal)


def _cfg(mode="reference", **kw):
    """``mode`` picks the gap estimator: the reference's explicit
    ``Jp + Jd`` or the complementarity form.  The explicit gap cancels
    the large constants Mp/Md, so near the tolerance its f32 rounding
    decides at which check a lane passes, and that differs between two
    float programs; both modes certify at 1e-4."""
    from pqp_for_mpc_tpu import SolverConfig
    comp = mode == "complementarity"
    args = dict(max_iters=2000, check_every=8, strict_weak_duality=False,
                gap_from_complementarity=comp,
                erc=1e-4, eac=1e-4, eaj=1e-4, erj=1e-4)
    args.update(kw)
    return SolverConfig(**args)


def _assert_same(ref, res, cadence=8):
    """Same verdicts and solutions; iteration counts equal up to the
    check cadence unless ``cadence`` is None."""
    np.testing.assert_array_equal(np.asarray(res.converged),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(np.asarray(res.diverged),
                                  np.asarray(ref.diverged))
    if cadence is not None:
        d_it = np.abs(np.asarray(res.iters) - np.asarray(ref.iters))
        assert d_it.max() <= cadence, d_it
    ok = np.asarray(ref.converged)
    np.testing.assert_allclose(np.asarray(res.U)[:, ok],
                               np.asarray(ref.U)[:, ok],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["reference", "complementarity"])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("N", [4, 16, 28, 64])
def test_kernel_matches_solve_batched(N, warm, mode):
    import jax.numpy as jnp
    from pqp_for_mpc_tpu import solve_batched
    from pqp_for_mpc_tpu.ops.solve_kernel import solve_fused

    B = 24
    primal, dual = _problem(N, B, seed=N)
    cfg = _cfg(mode)
    Y0 = None
    if warm:
        rng = np.random.default_rng(1)
        Y0 = jnp.asarray(rng.uniform(0.1, 10.0, (N, B)).astype(np.float32))
    ref = solve_batched(primal, dual, Y0=Y0, cfg=cfg)
    res = solve_fused(primal, dual, Y0=Y0, cfg=cfg, interpret=True)
    assert np.asarray(ref.converged).any()
    _assert_same(ref, res, cadence=8 if mode == "complementarity" else None)


def test_kernel_batch_not_multiple_of_lane_block():
    """Padded lanes start frozen and never reach the results."""
    from pqp_for_mpc_tpu import solve_batched
    from pqp_for_mpc_tpu.ops.solve_kernel import (_pad_dim, launch_shape,
                                                  solve_fused)

    N = 28
    bb, _ = launch_shape(_pad_dim(N))
    B = bb + 7
    primal, dual = _problem(N, B, seed=3)
    cfg = _cfg("complementarity")
    res = solve_fused(primal, dual, cfg=cfg, interpret=True)
    assert res.U.shape == (primal.Gp.shape[1], B)
    assert res.Y.shape == (N, B) and res.iters.shape == (B,)
    _assert_same(solve_batched(primal, dual, cfg=cfg), res)


def test_kernel_lane_hits_max_iters():
    """A lane still active at max_iters reports the exit count, exactly
    as solve_batched does, and is not certified."""
    from pqp_for_mpc_tpu import solve_batched
    from pqp_for_mpc_tpu.ops.solve_kernel import solve_fused

    primal, dual = _problem(28, 8, seed=5)
    cfg = _cfg(max_iters=24)
    ref = solve_batched(primal, dual, cfg=cfg)
    res = solve_fused(primal, dual, cfg=cfg, interpret=True)
    assert not np.asarray(res.converged).all()
    _assert_same(ref, res)
    stuck = ~np.asarray(res.converged)
    assert (np.asarray(res.iters)[stuck] == 25).all()


def test_kernel_nan_lane_freezes_as_diverged():
    import jax.numpy as jnp
    from pqp_for_mpc_tpu import solve_batched
    from pqp_for_mpc_tpu.ops.solve_kernel import solve_fused

    N, B = 16, 6
    primal, dual = _problem(N, B, seed=7)
    Y0 = jnp.full((N, B), 2.0, jnp.float32).at[3, 2].set(jnp.nan)
    cfg = _cfg("complementarity")
    ref = solve_batched(primal, dual, Y0=Y0, cfg=cfg)
    res = solve_fused(primal, dual, Y0=Y0, cfg=cfg, interpret=True)
    assert bool(np.asarray(res.diverged)[2])
    assert not bool(np.asarray(res.converged)[2])
    assert int(np.asarray(res.iters)[2]) == 1
    _assert_same(ref, res)


def test_kernel_rejects_large_n_and_routes_it_to_xla():
    from pqp_for_mpc_tpu.ops.solve_kernel import MAX_FUSED_N, solve_fused
    from pqp_for_mpc_tpu.routing import route_solve

    N = 100
    assert N > MAX_FUSED_N
    primal, dual = _problem(N, 4)
    assert dual.n_con == N
    with pytest.raises(ValueError, match="N <= 64"):
        solve_fused(primal, dual, cfg=_cfg(), interpret=True)
    assert route_solve(N, 1 << 20, False, _cfg(), platform="gpu") == "xla"


@pytest.mark.parametrize("kw", [{"accel_every": 4},
                                {"feas_from_dual_gradient": True}])
def test_kernel_rejects_configs_it_does_not_certify(kw):
    from pqp_for_mpc_tpu.ops.solve_kernel import fused_supports, solve_fused

    primal, dual = _problem(28, 4)
    cfg = _cfg(**kw)
    assert not fused_supports(dual, cfg)
    with pytest.raises(ValueError, match="solve_batched"):
        solve_fused(primal, dual, cfg=cfg, interpret=True)


def test_padding_and_launch_shape():
    """Dot operands are powers of two >= 16; the lane blocks are the
    swept ones."""
    from pqp_for_mpc_tpu.ops.solve_kernel import _pad_dim, launch_shape

    assert [_pad_dim(n) for n in (1, 4, 16, 17, 28, 64)] == \
        [16, 16, 16, 32, 32, 64]
    assert launch_shape(16) == launch_shape(32) == (64, 4)
    assert launch_shape(64) == (16, 4)


@pytest.mark.gpu
def test_kernel_compiled_matches_solve_batched_on_gpu(gpu_device):
    from pqp_for_mpc_tpu import SolverConfig, dualize, solve_batched
    from pqp_for_mpc_tpu.models.example import example_problem
    from pqp_for_mpc_tpu.ops.solve_kernel import solve_fused

    primal = example_problem(4096, seed=0)
    dual = dualize(primal)
    cfg = SolverConfig(max_iters=5000, check_every=8,
                       strict_weak_duality=False,
                       gap_from_complementarity=True)
    ref = solve_batched(primal, dual, cfg=cfg)
    res = solve_fused(primal, dual, cfg=cfg)
    assert bool(np.asarray(ref.converged).all())
    _assert_same(ref, res)
