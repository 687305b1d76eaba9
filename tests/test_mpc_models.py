"""Tests for the model zoo + condensation + receding-horizon loop.

Validation strategy: the condensed QP's cost must equal the explicitly
rolled-out tracking cost for arbitrary U (the reference has no such check —
it trusts its text files), and the closed loop must regulate the plant.
"""

import numpy as np
import pytest


def _spec(plant, H=5, seed=0):
    from pqp_for_mpc_tpu.models import MPCSpec
    rng = np.random.default_rng(seed)
    ny, nu = plant.n_output, plant.n_input
    return MPCSpec(
        plant=plant, horizon=H,
        Qy=np.eye(ny, dtype=np.float32),
        R=0.1 * np.eye(nu, dtype=np.float32),
        r=rng.uniform(-1, 1, ny).astype(np.float32),
        u_min=-2.0 * np.ones(nu, np.float32),
        u_max=2.0 * np.ones(nu, np.float32),
        du_max=1.0 * np.ones(nu, np.float32),
    )


def _rollout_cost(spec, x0, D_seq, U):
    """Explicit simulation of J = sum (y-r)'Qy(y-r) + u'Ru."""
    plant, H = spec.plant, spec.horizon
    nu, nd = plant.n_input, plant.n_dist
    x = x0.copy()
    J = 0.0
    for k in range(H):
        u = U[k * nu:(k + 1) * nu]
        d = D_seq[k * nd:(k + 1) * nd]
        x = plant.A @ x + plant.B @ u + plant.E @ d
        y = plant.C @ x
        e = y - spec.r
        J += float(e @ spec.Qy @ e + u @ spec.R @ u)
    return J


@pytest.mark.parametrize("plant_name", ["double_integrator",
                                        "mass_spring_damper", "thermal_rc",
                                        "dc_motor", "aircraft_pitch",
                                        "quadruple_tank"])
def test_condensed_cost_matches_rollout(plant_name):
    from pqp_for_mpc_tpu.models import ZOO, condense
    import jax.numpy as jnp

    plant = ZOO[plant_name]() if plant_name != "thermal_rc" else \
        ZOO[plant_name](n_rooms=8, n_heaters=3)
    spec = _spec(plant, H=4)
    data = condense(spec)

    rng = np.random.default_rng(1)
    x0 = rng.uniform(-1, 1, plant.n_state).astype(np.float32)
    D = rng.uniform(-1, 1, spec.horizon * plant.n_dist).astype(np.float32)
    U = rng.uniform(-1, 1, spec.horizon * plant.n_input).astype(np.float32)

    primal = data.assemble(x=jnp.asarray(x0), D=jnp.asarray(D))
    # QP cost 1/2 U'QpU + Fp'U + 1/2 Mp == rolled-out tracking cost.
    # data.qp() is the exactly-built Hessian: kappa(Qp) reaches ~2e11
    # for thermal_rc, where inverting the f32 Qp_inv cannot recover Qp
    # (the information is gone below eps_f32) — the stored-Qp path is
    # what the framework itself uses (MPCController, problem.assemble).
    Qp = np.asarray(data.qp())
    J_qp = (0.5 * U @ Qp @ U + np.asarray(primal.Fp) @ U
            + 0.5 * float(primal.Mp))
    J_sim = _rollout_cost(spec, x0, D, U)
    assert abs(J_qp - J_sim) <= 1e-3 * max(1.0, abs(J_sim))


def test_constraint_rows_structure():
    from pqp_for_mpc_tpu.models import ZOO, input_constraints
    plant = ZOO["double_integrator"]()
    spec = _spec(plant, H=6)
    Gp, Kp = input_constraints(spec)
    M = 6 * plant.n_input
    assert Gp.shape == (4 * M, M)  # reference's N = 4*pHorizon*nInput
    assert Kp.shape == (4 * M,)
    # a feasible point: U = 0 satisfies all rows (0 <= Kp)
    assert np.all(np.asarray(Kp) >= 0)


def test_mpc_solves_and_is_feasible():
    from pqp_for_mpc_tpu.models import ZOO, MPCController
    plant = ZOO["double_integrator"]()
    spec = _spec(plant, H=5)
    ctrl = MPCController(spec)   # MPC_CONFIG defaults
    x0 = np.array([1.0, 0.0], np.float32)
    u0, res = ctrl.step(x0)
    assert bool(np.asarray(res.converged).all())
    u = np.asarray(res.U).ravel()
    assert np.all(u <= 2.0 + 1e-3) and np.all(u >= -2.0 - 1e-3)
    du = np.diff(np.concatenate([[0.0], u]))
    assert np.all(np.abs(du) <= 1.0 + 1e-3)


def test_dual_geometry_split_matches_dualize():
    """dual_geometry + dualize_forcing == dualize (the split powers the
    jitted receding-horizon loop)."""
    import jax.numpy as jnp
    from pqp_for_mpc_tpu import dualize
    from pqp_for_mpc_tpu.dual import dual_geometry, dualize_forcing
    from pqp_for_mpc_tpu.models import ZOO, condense

    spec = _spec(ZOO["double_integrator"](), H=6)
    data = condense(spec)
    Qp = jnp.linalg.inv(data.Qp_inv)
    primal = data.assemble(x=jnp.asarray([0.7, -0.3], jnp.float32),
                           D=jnp.zeros(6, jnp.float32), Qp=Qp)
    full = dualize(primal)
    geom = dual_geometry(primal.Gp, primal.Qp_inv)
    part = dualize_forcing(geom, primal.Fp, primal.Mp, primal.Kp)
    for f in ("Qd", "Fd", "Md", "theta", "Qdp_theta", "Qdn_theta",
              "Fdp", "Fdn"):
        np.testing.assert_allclose(np.asarray(getattr(part, f)),
                                   np.asarray(getattr(full, f)),
                                   rtol=1e-6, atol=1e-6)


def test_rollout_jit_matches_host_rollout():
    """The scan-compiled closed loop regulates like the host loop and
    reports per-step convergence."""
    from pqp_for_mpc_tpu.models import MPCSpec, MPCController, double_integrator

    plant = double_integrator()
    spec = MPCSpec(
        plant=plant, horizon=16,
        Qy=np.eye(1, dtype=np.float32), R=0.05 * np.eye(1, dtype=np.float32),
        r=np.zeros(1, np.float32),
        u_min=np.array([-1.0], np.float32), u_max=np.array([1.0], np.float32),
        du_max=np.array([0.5], np.float32))
    ctrl = MPCController(spec)
    out = ctrl.rollout_jit(np.array([2.0, 0.0], np.float32), steps=40)
    assert bool(out["converged"].all())
    assert abs(out["x"][-1][0]) < 0.1
    # same trajectory shape as the host loop, compared loosely (the host
    # loop floors warm starts identically)
    host = MPCController(spec).rollout(np.array([2.0, 0.0], np.float32),
                                       steps=10)
    np.testing.assert_allclose(out["u"][:10, 0], host["u"][:10, 0],
                               atol=5e-3)


def test_scaled_condensed_mpc_horizon50():
    """BASELINE config 3: horizon 50, 12-state/4-input random stable
    plant -> M=200 vars, N=800 constraints; the solver must converge
    with practical tolerances."""
    import jax.numpy as jnp
    from pqp_for_mpc_tpu.config import MPC_CONFIG
    from pqp_for_mpc_tpu.models import MPCSpec, MPCController, random_stable

    plant = random_stable(12, 4, seed=7)
    ny, nu = plant.n_output, plant.n_input
    spec = MPCSpec(
        plant=plant, horizon=50,
        Qy=np.eye(ny, dtype=np.float32), R=0.1 * np.eye(nu, dtype=np.float32),
        r=np.zeros(ny, np.float32),
        u_min=-2 * np.ones(nu, np.float32), u_max=2 * np.ones(nu, np.float32),
        du_max=np.ones(nu, np.float32))
    ctrl = MPCController(spec)
    assert ctrl.data.Gp.shape == (800, 200)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.5, 0.5, 12).astype(np.float32)
    u0, res = ctrl.step(x0)
    assert bool(np.asarray(res.converged).all())
    assert bool(np.asarray(res.feasible).all())


def test_u_prev_delta_not_double_counted():
    """A spec built with a base u_prev must not add the runtime u_prev on
    top of it: the stage-0 slew bound is du_max +/- u_prev exactly."""
    import dataclasses as dc
    import jax.numpy as jnp
    from pqp_for_mpc_tpu.models import MPCSpec, MPCController, double_integrator

    plant = double_integrator()
    spec = MPCSpec(
        plant=plant, horizon=4,
        Qy=np.eye(1, dtype=np.float32), R=0.1 * np.eye(1, dtype=np.float32),
        r=np.zeros(1, np.float32),
        u_min=-np.ones(1, np.float32), u_max=np.ones(1, np.float32),
        du_max=np.array([0.5], np.float32),
        u_prev=np.array([0.4], np.float32))     # baked-in base
    ctrl = MPCController(spec)
    M = 4
    # access the Kp the solve actually uses via the same delta path
    up = jnp.asarray([0.3], jnp.float32) - ctrl._u_base
    e1u = jnp.zeros(M, jnp.float32).at[:1].set(up)
    Kp = ctrl.data.Kp.at[2 * M:3 * M].add(e1u).at[3 * M:4 * M].add(-e1u)
    # slew+ row 0: du_max + u_prev_runtime = 0.5 + 0.3
    assert abs(float(Kp[2 * M]) - 0.8) < 1e-6
    # slew- row 0: du_max - u_prev_runtime = 0.5 - 0.3
    assert abs(float(Kp[3 * M]) - 0.2) < 1e-6


def test_rollout_jit_honors_warm_start_modes():
    """rollout_jit must apply the controller's warm-start mode inside the
    scan (shift/plain/off give different iteration profiles but the same
    trajectory)."""
    from pqp_for_mpc_tpu.models import MPCSpec, MPCController, double_integrator

    plant = double_integrator()
    spec = MPCSpec(
        plant=plant, horizon=12,
        Qy=np.eye(1, dtype=np.float32), R=0.05 * np.eye(1, dtype=np.float32),
        r=np.zeros(1, np.float32),
        u_min=np.array([-1.0], np.float32), u_max=np.array([1.0], np.float32),
        du_max=np.array([0.5], np.float32))
    outs = {}
    for mode in (True, False, "shift"):
        outs[mode] = MPCController(spec, warm_start=mode).rollout_jit(
            np.array([1.5, 0.0], np.float32), steps=15)
        assert bool(outs[mode]["converged"].all())
    np.testing.assert_allclose(outs[True]["u"], outs[False]["u"], atol=5e-3)
    np.testing.assert_allclose(outs[True]["u"], outs["shift"]["u"],
                               atol=5e-3)
    # cold restarts shouldn't be cheaper than warm starts overall
    assert (outs[True]["iters"][1:].mean()
            <= outs[False]["iters"][1:].mean() + 8)


def test_shifted_warm_start_reduces_iterations():
    from pqp_for_mpc_tpu.models import MPCSpec, MPCController, double_integrator

    plant = double_integrator()
    spec = MPCSpec(
        plant=plant, horizon=16,
        Qy=np.eye(1, dtype=np.float32), R=0.05 * np.eye(1, dtype=np.float32),
        r=np.zeros(1, np.float32),
        u_min=np.array([-1.0], np.float32), u_max=np.array([1.0], np.float32),
        du_max=np.array([0.5], np.float32))
    plain = MPCController(spec, warm_start=True).rollout(
        np.array([2.0, 0.0], np.float32), steps=25)
    shifted = MPCController(spec, warm_start="shift").rollout(
        np.array([2.0, 0.0], np.float32), steps=25)
    assert abs(shifted["x"][-1][0]) < 0.3
    assert (shifted["iters"][1:].mean()
            <= 1.05 * plain["iters"][1:].mean())


def test_output_constraints_condensation_math():
    """Kp(x, D) = Kp0 + Kx x + Kd D must equal the bound computed from
    the explicit prediction: CSu U <= ymax - CSx x - CSd D."""
    import dataclasses as dc
    import jax.numpy as jnp
    from pqp_for_mpc_tpu.models import ZOO, condense
    from pqp_for_mpc_tpu.models.mpc import prediction_matrices

    plant = ZOO["double_integrator"]()
    spec = _spec(plant, H=4)
    spec = dc.replace(spec, y_min=np.array([-0.8], np.float32),
                      y_max=np.array([1.2], np.float32))
    data = condense(spec)
    H, nu, ny = 4, plant.n_input, plant.n_output
    M = H * nu
    assert data.Gp.shape == (4 * M + 2 * H * ny, M)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, plant.n_state).astype(np.float32)
    D = rng.uniform(-1, 1, H * plant.n_dist).astype(np.float32)
    primal = data.assemble(x=jnp.asarray(x), D=jnp.asarray(D),
                           Qp=jnp.linalg.inv(data.Qp_inv))
    # explicit bound for the upper-output rows
    Sx, Su, Sd = prediction_matrices(plant, H)
    Cs = np.kron(np.eye(H, dtype=np.float32), np.asarray(plant.C))
    c = Cs @ (np.asarray(Sx) @ x + np.asarray(Sd) @ D)
    upper = np.tile([1.2], H) - c
    lower = -(np.tile([-0.8], H)) + c
    got = np.asarray(primal.Kp)
    np.testing.assert_allclose(got[4 * M:4 * M + H * ny], upper, atol=1e-4)
    np.testing.assert_allclose(got[4 * M + H * ny:], lower, atol=1e-4)


def test_output_constrained_closed_loop_respects_bounds():
    """Closed loop with an output ceiling: position must not exceed it
    (beyond small solver tolerance), while an unconstrained run would."""
    import dataclasses as dc
    from pqp_for_mpc_tpu.models import MPCSpec, MPCController, double_integrator

    plant = double_integrator()
    base = MPCSpec(
        plant=plant, horizon=16,
        Qy=np.eye(1, dtype=np.float32), R=0.02 * np.eye(1, dtype=np.float32),
        r=np.ones(1, np.float32) * 1.5,          # reference ABOVE the cap
        u_min=np.array([-1.0], np.float32), u_max=np.array([1.0], np.float32),
        du_max=np.array([0.5], np.float32))
    capped = dc.replace(base, y_max=np.array([1.0], np.float32),
                        y_min=np.array([-2.0], np.float32))

    free = MPCController(base).rollout(np.array([0.0, 0.0], np.float32),
                                       steps=40)
    assert free["x"][:, 0].max() > 1.2           # tracks 1.5, crosses cap

    ctrl = MPCController(capped)
    out = ctrl.rollout(np.array([0.0, 0.0], np.float32), steps=40)
    assert out["x"][:, 0].max() <= 1.0 + 5e-2
    # still pushes toward the cap rather than stalling at 0
    assert out["x"][-1, 0] > 0.8


def test_soft_output_constraints_feasible_when_hard_is_not():
    """A hard output cap below the current output is infeasible for the
    one-step QP; the softened problem solves and pushes toward the cap
    with bounded violation ~ 1/rho."""
    import dataclasses as dc
    from pqp_for_mpc_tpu.models import MPCSpec, MPCController, double_integrator

    plant = double_integrator()
    base = MPCSpec(
        plant=plant, horizon=10,
        Qy=np.eye(1, dtype=np.float32), R=0.05 * np.eye(1, dtype=np.float32),
        r=np.zeros(1, np.float32),
        u_min=np.array([-1.0], np.float32), u_max=np.array([1.0], np.float32),
        du_max=np.array([0.5], np.float32),
        y_max=np.array([0.5], np.float32),
        y_min=np.array([-2.0], np.float32))
    # x0 = [2, 1]: position 2 > cap 0.5 and still moving up — with
    # |u| <= 1 and slew 0.5 the output cap cannot be met for several
    # steps => the hard QP is infeasible at this state.
    x0 = np.array([2.0, 1.0], np.float32)

    hard = MPCController(base)
    _, res_h = hard.step(x0)
    assert not bool(np.asarray(res_h.converged).all())   # infeasible

    # engineering tolerances: the softened QP's output rows are tight
    # equalities at the optimum, so 1e-4 absolute feasibility needs far
    # more dual refinement than any controller cares about
    from pqp_for_mpc_tpu.config import MPC_CONFIG
    cfg = dc.replace(MPC_CONFIG, erc=1e-3, eac=1e-3)
    soft = MPCController(dc.replace(base, soft_penalty=50.0), cfg=cfg)
    assert soft.data.n_var == 10 + 2 * 10        # U + slacks
    _, res_s = soft.step(x0)
    assert bool(np.asarray(res_s.converged).all())
    u = np.asarray(res_s.U)[:10].ravel()
    assert np.all(u <= 1.0 + 1e-3)               # input bounds still hard
    s = np.asarray(res_s.U)[10:].ravel()
    assert np.all(s >= -1e-4)                    # slacks nonnegative
    assert s.max() > 0.1                         # actually used


def test_soft_matches_hard_when_inactive():
    """With the cap far away, soft and hard give the same control."""
    import dataclasses as dc
    from pqp_for_mpc_tpu.models import MPCSpec, MPCController, double_integrator

    plant = double_integrator()
    base = MPCSpec(
        plant=plant, horizon=8,
        Qy=np.eye(1, dtype=np.float32), R=0.05 * np.eye(1, dtype=np.float32),
        r=np.zeros(1, np.float32),
        u_min=np.array([-1.0], np.float32), u_max=np.array([1.0], np.float32),
        du_max=np.array([0.5], np.float32),
        y_max=np.array([50.0], np.float32), y_min=np.array([-50.0], np.float32))
    x0 = np.array([1.0, 0.0], np.float32)
    u_h, _ = MPCController(base).step(x0)
    u_s, _ = MPCController(dc.replace(base, soft_penalty=100.0)).step(x0)
    np.testing.assert_allclose(np.asarray(u_s), np.asarray(u_h), atol=5e-3)


def test_accel_step_escapes_absorbing_zero():
    """Y_i = 0 is an absorbing state of the multiplicative update; the
    projected-gradient acceleration must be able to leave it when the
    gradient points inward (grad_i < 0)."""
    import jax.numpy as jnp
    from pqp_for_mpc_tpu.solver import accel_step, pqp_update
    from pqp_for_mpc_tpu.problem import DualQP

    Qd = jnp.eye(2, dtype=jnp.float32)
    Fd = jnp.array([-1.0, 1.0], jnp.float32)   # optimum Y* = (1, 0)
    theta = jnp.full((2,), 5.0, jnp.float32)
    dual = DualQP(Qd=Qd, Fd=Fd, Md=jnp.float32(0), theta=theta,
                  Qdp_theta=Qd + jnp.diag(theta), Qdn_theta=jnp.diag(theta),
                  Fdp=jnp.maximum(Fd, 0), Fdn=jnp.maximum(-Fd, 0))
    Y = jnp.zeros((2, 1), jnp.float32)         # stuck for the mult. update
    Ym = pqp_update(dual, Y, den_eps=1e-30)
    np.testing.assert_allclose(np.asarray(Ym), 0.0)  # absorbing indeed
    Ya = accel_step(dual, Y, jnp.zeros(1, bool))
    assert float(Ya[0, 0]) > 0.5               # moved toward Y*_0 = 1
    assert float(Ya[1, 0]) == 0.0              # stays on the boundary


def test_receding_horizon_regulates_and_warm_start_helps():
    from pqp_for_mpc_tpu.models import MPCSpec, MPCController, double_integrator

    # Horizon 16: the double integrator needs >= ~1.5 s of lookahead to
    # brake without overshooting from x0 = [2, 0] under |u| <= 1.
    plant = double_integrator()
    spec = MPCSpec(
        plant=plant, horizon=16,
        Qy=np.eye(1, dtype=np.float32), R=0.05 * np.eye(1, dtype=np.float32),
        r=np.zeros(1, np.float32),
        u_min=np.array([-1.0], np.float32), u_max=np.array([1.0], np.float32),
        du_max=np.array([0.5], np.float32))

    warm = MPCController(spec, warm_start=True)
    out = warm.rollout(np.array([2.0, 0.0], np.float32), steps=30)
    # position regulated toward 0, every step converged quickly
    assert abs(out["x"][-1][0]) < 0.3
    assert out["iters"].max() < 2_000
    # warm starting does not hurt (and typically helps) after step 0
    cold = MPCController(spec, warm_start=False)
    out_c = cold.rollout(np.array([2.0, 0.0], np.float32), steps=10)
    assert (np.mean(out["iters"][1:10])
            <= 1.2 * np.mean(out_c["iters"][1:10]))


def _di_spec(H):
    from pqp_for_mpc_tpu.models import MPCSpec, double_integrator

    return MPCSpec(
        plant=double_integrator(), horizon=H,
        Qy=np.eye(1, dtype=np.float32),
        R=0.05 * np.eye(1, dtype=np.float32),
        r=np.zeros(1, np.float32),
        u_min=np.array([-1.0], np.float32),
        u_max=np.array([1.0], np.float32),
        du_max=np.array([0.5], np.float32))


def test_controller_stagewise_backend_matches_condensed():
    """backend='stagewise' drives the same closed loop as the condensed
    backend (same spec, same warm-start semantics) without ever building
    the O((H*nu)^2) condensed blocks."""
    from pqp_for_mpc_tpu.models import MPCController

    spec = _di_spec(16)
    x0 = np.array([2.0, 0.0], np.float32)
    ref = MPCController(spec).rollout(x0, steps=12)
    ctrl = MPCController(spec, backend="stagewise")
    assert ctrl.data is None          # condensed blocks never built
    out = ctrl.rollout(x0, steps=12)
    np.testing.assert_allclose(out["u"][:, 0], ref["u"][:, 0], atol=5e-3)
    np.testing.assert_allclose(out["x"], ref["x"], atol=2e-2)


def test_controller_stagewise_batch_transition():
    """A warm-started stage-wise controller accepts a batch-size change:
    the carried (N, 1) multipliers seed every lane of the next batched
    step (the unbroadcast Y0 used to crash the while_loop with a
    carry-shape mismatch)."""
    from pqp_for_mpc_tpu.models import MPCController

    ctrl = MPCController(_di_spec(16), backend="stagewise")
    u0, _ = ctrl.step(np.array([2.0, 0.0], np.float32))
    xb = np.array([[2.0, 1.0, -1.5, 0.3], [0.0, 0.5, 0.2, -0.4]],
                  np.float32)
    u0b, resb = ctrl.step(xb)
    assert u0b.shape == (1, 4)
    assert np.isfinite(np.asarray(resb.U)).all()
    assert bool(np.asarray(resb.converged).all()), resb.stats()


def test_controller_stagewise_rollout_jit():
    """The stage-wise backend's fully-jitted scan rollout regulates a
    long-horizon (H=128) double integrator — a problem size where the
    condensed dual would be (4*128)^2 dense.

    The default cfg (config.stagewise_mpc_config) lifts the tolerances
    to the horizon's float32 certification floor — conditioning grows
    ~H^4, so MPC_CONFIG's 1e-4 slacks are certifiable only up to H~32;
    at H=128 the feasibility residual stalls at ~2.5e-3 and the
    relative gap at 3e-3..1e-2 (scale-invariant: the gap is a
    difference of O(kappa*eps)-noisy f32 objectives).  Right AT the
    floor certification is noise-marginal — a few steps can land one
    check above the gap tolerance and run to max_iters — so the test
    asserts a high certified fraction plus regulation quality, not
    all-steps certification.  See also
    test_stagewise.py::test_stagewise_long_horizon_linear_memory
    (H=512 floors)."""
    import dataclasses
    from pqp_for_mpc_tpu.config import stagewise_mpc_config
    from pqp_for_mpc_tpu.models import MPCController

    spec = _di_spec(128)
    cfg = dataclasses.replace(stagewise_mpc_config(128), max_iters=3_000)
    ctrl = MPCController(spec, cfg=cfg, backend="stagewise",
                         warm_start="shift")
    out = ctrl.rollout_jit(np.array([2.0, 0.0], np.float32), steps=30)
    conv = out["converged"]
    assert conv.mean() >= 0.8, out["iters"]
    assert bool(conv[0]), out["iters"][0]        # the cold solve certifies
    # the loop regulates the state to the origin regardless
    assert abs(out["x"][-1][0]) < 0.1
    # warm-started certified steps converge far faster than the cold solve
    warm = out["iters"][5:][conv[5:]]
    assert warm.mean() <= 0.2 * out["iters"][0], (warm, out["iters"][0])


def test_controller_retry_cold_recovers_bad_warm_start():
    """retry_cold=True re-solves uncertified steps from the cold start
    (certify-or-recover).  Forced failure: warm_start_floor=1e6 raises
    every carried multiplier to 1e6 — a warm start so bad the
    multiplicative update cannot decay it within max_iters (the Y0=1000
    cold start already needs ~51k iterations on this plant; see the
    MPC_CONFIG rationale comment) — so WITHOUT the retry every step
    runs uncertified, and WITH it every step certifies via the cold
    re-solve."""
    import dataclasses
    from pqp_for_mpc_tpu.config import MPC_CONFIG
    from pqp_for_mpc_tpu.models import MPCController

    spec = _di_spec(16)
    cfg = dataclasses.replace(MPC_CONFIG, max_iters=2000)
    x0 = np.array([2.0, 0.0], np.float32)

    bad = MPCController(spec, cfg=cfg, warm_start_floor=1e6)
    out_bad = bad.rollout_jit(x0, steps=6)
    assert not out_bad["converged"].any(), out_bad["iters"]

    fixed = MPCController(spec, cfg=cfg, warm_start_floor=1e6,
                          retry_cold=True)
    out = fixed.rollout_jit(x0, steps=6)
    assert bool(out["converged"].all()), out["iters"]
    assert abs(out["x"][-1][0]) < abs(x0[0])   # regulating

    # eager step path: same recovery, per-lane
    fixed.reset()
    fixed.step(x0)                      # seeds the poisoned warm start
    _, res = fixed.step(np.array([[1.5, 0.5], [0.1, -0.2]], np.float32))
    assert bool(np.asarray(res.converged).all()), res.stats()


def test_controller_retry_cold_stagewise_backend():
    """Same certify-or-recover through the stage-wise scan rollout."""
    import dataclasses
    from pqp_for_mpc_tpu.config import stagewise_mpc_config
    from pqp_for_mpc_tpu.models import MPCController

    spec = _di_spec(16)
    cfg = dataclasses.replace(stagewise_mpc_config(16), max_iters=2000)
    x0 = np.array([2.0, 0.0], np.float32)
    ctrl = MPCController(spec, cfg=cfg, backend="stagewise",
                         warm_start_floor=1e6, retry_cold=True)
    out = ctrl.rollout_jit(x0, steps=6)
    assert bool(out["converged"].all()), out["iters"]


def test_controller_retry_cold_h512_compiles():
    """The H=512 retry_cold rollout graph compiles and runs (ROADMAP
    #10: a lax.cond form would DUPLICATE the while-loop-of-
    associative-scan solve per scan step; the single-call-site
    retry_cold_solve keeps one solve instance).  Tiny iteration
    budget — this pins compile+run, not certification."""
    import dataclasses
    from pqp_for_mpc_tpu.config import stagewise_mpc_config
    from pqp_for_mpc_tpu.models import MPCController

    spec = _di_spec(512)
    cfg = dataclasses.replace(stagewise_mpc_config(512), max_iters=64,
                              check_every=16, accel_every=8)
    ctrl = MPCController(spec, cfg=cfg, backend="stagewise",
                         warm_start="shift", retry_cold=True)
    out = ctrl.rollout_jit(np.array([2.0, 0.0], np.float32), steps=2)
    assert out["u"].shape == (2, 1)
    assert np.isfinite(out["x"]).all()
