"""Nonlinear MPC by real-time iteration (RTI), fully compiled.

The reference solves one precondensed LTI QP per process invocation
(PQP_CPU.c:757-930).  This module composes the framework's LTV surface
into the classic successive-linearization controller for NONLINEAR
plants — and, because every build stage is pure jnp
(:func:`~pqp_for_mpc_tpu.models.stagewise.relinearize`), the ENTIRE
control step compiles into one XLA graph:

    Jacobians of the user dynamics along the shifted nominal plan
    (``jax.jacobian``, vmapped over stages)
      → time-varying Riccati factorization
      → split radii / banded |Qd| blocks / theta
      → matrix-free PQP solve (warm-started)
      → first input applied.

:meth:`RTIController.rollout` goes further and runs the CLOSED LOOP —
relinearization, QP solve, and the true nonlinear plant propagation for
every control step — inside one ``lax.scan`` dispatch, the same
structure as ``MPCController.rollout_jit`` but with the QP
itself rebuilt from fresh Jacobians each step.  Nothing in the
reference's architecture (a main() per QP) can express this.

The linearization error rides the disturbance channel: with
``x+ ~ A x + B u + c``, ``c = f(xbar, ubar) - A xbar - B ubar``, the
affine remainder ``c`` is exactly a known per-stage disturbance under
``E = I`` — so the controller requires ``spec.plant.E`` to be identity
stacks and feeds ``dseq = c``.

Output maps stay linear (``y = C x``): mechanical tracking outputs are
selections/combinations of states.  For a nonlinear measurement, extend
the state with the measured quantity in ``f_disc``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from pqp_for_mpc_tpu.config import SolverConfig, stagewise_mpc_config
from pqp_for_mpc_tpu.models.mpc import MPCSpec
from pqp_for_mpc_tpu.models.stagewise import (
    relinearize,
    solve_stagewise,
    stagewise_dual,
)


class RTIController:
    """Receding-horizon controller for a nonlinear plant via
    relinearize-and-solve (one or more SQP passes per step).

    ``f_disc``: traceable discrete dynamics ``(x (ns,), u (nu,)) ->
    x_next (ns,)`` (e.g. an RK4 step of a continuous model).

    ``spec``: the QP shape — horizon, weights, bounds, and a plant
    whose matrices give the dimensions and the FIRST linearization
    (e.g. Jacobians at the origin, or any
    :class:`~pqp_for_mpc_tpu.models.plants.LTVPlant` along a nominal
    guess).  ``spec.plant.E`` must be the identity (the remainder
    channel, see module docstring); ``spec.plant.C`` is the fixed
    linear output map.

    ``sqp_iters``: relinearize+solve passes per control step.  1 is
    the classic real-time iteration (warm-started by the shifted
    previous plan); 2-3 tighten the plan when the trajectory moves
    fast relative to the horizon.

    The expensive structural choices (band width, theta floor) are made
    ONCE here by :func:`stagewise_dual` on the initial linearization;
    every subsequent step reuses them through :func:`relinearize`
    inside the jitted step.
    """

    def __init__(self, f_disc: Callable, spec: MPCSpec,
                 cfg: Optional[SolverConfig] = None,
                 sqp_iters: int = 1,
                 band: Optional[int] = None,
                 warm_start: bool = True,
                 warm_start_floor: float = 0.01):
        plant = spec.plant
        H, ns, nu = spec.horizon, plant.n_state, plant.n_input
        E = np.broadcast_to(np.asarray(plant.E, np.float32),
                            (H, ns, plant.n_dist))
        if plant.n_dist != ns or not np.allclose(
                E, np.broadcast_to(np.eye(ns, dtype=np.float32),
                                   (H, ns, ns))):
            raise ValueError(
                "RTIController needs spec.plant.E = identity stacks "
                "(the linearization remainder rides the disturbance "
                "channel, see models/rti.py docstring)")
        self.f_disc = f_disc
        self.spec = spec
        self.cfg = cfg if cfg is not None else stagewise_mpc_config(H)
        self.sqp_iters = int(sqp_iters)
        self.warm_start = warm_start
        self.warm_start_floor = float(warm_start_floor)
        self._sd0 = stagewise_dual(spec, theta_floor=self.cfg.theta_floor,
                                   band=band)
        self._H, self._ns, self._nu = H, ns, nu
        self._step_fn = jax.jit(self._make_step())
        self._rollout_fns = {}
        self.reset()

    @property
    def band(self) -> int:
        return self._sd0.band

    def reset(self):
        self._useq = jnp.zeros((self._H, self._nu), jnp.float32)
        self._u_prev = jnp.zeros(self._nu, jnp.float32)
        self._Y = jnp.zeros((self._sd0.n_con, 1), jnp.float32)

    def _make_step(self):
        f_disc, cfg = self.f_disc, self.cfg
        sd0, H, nu = self._sd0, self._H, self._nu
        floor = self.warm_start_floor

        def jacs(x, u):
            A = jax.jacobian(f_disc, argnums=0)(x, u)
            B = jax.jacobian(f_disc, argnums=1)(x, u)
            c = f_disc(x, u) - A @ x - B @ u
            return A, B, c

        def nominal(x, useq):
            def prop(xk, uk):
                return f_disc(xk, uk), xk
            _, xs = lax.scan(prop, x, useq)
            return xs                      # xbar_k = state ENTERING k

        def step(x, useq, u_prev, Y):
            # shift the previous plan one stage (receding horizon)
            useq = jnp.concatenate([useq[1:], useq[-1:]])
            res = None
            for _ in range(self.sqp_iters):
                xbar = nominal(x, useq)
                A, B, c = jax.vmap(jacs)(xbar, useq)
                sd = relinearize(sd0, A, B, u_prev=u_prev)
                Y0 = jnp.maximum(Y, floor) if self.warm_start else None
                res = solve_stagewise(sd, x[:, None],
                                      dseq=c[:, :, None], Y0=Y0, cfg=cfg)
                useq = res.U.reshape(H, nu)
                Y = res.Y
            return useq[0], useq, Y, res

        return step

    def step(self, x):
        """One control step: returns ``(u0 (nu,), SolveResult)`` and
        advances the internal plan/warm-start state.  One compiled
        dispatch (Jacobians, Riccati, split, solve)."""
        x = jnp.asarray(x, jnp.float32)
        u0, self._useq, self._Y, res = self._step_fn(
            x, self._useq, self._u_prev, self._Y)
        self._u_prev = u0
        return u0, res

    def rollout(self, x0, steps: int):
        """Fully-jitted nonlinear closed loop: ``lax.scan`` over control
        steps with relinearization, the PQP solve, AND the true
        nonlinear plant propagation (``f_disc``) in one compiled graph.
        Returns dict of stacked trajectories (x, u, iters, converged).
        """
        run = self._rollout_fns.get(steps)
        if run is None:
            step_fn = self._make_step()
            f_disc, H, nu = self.f_disc, self._H, self._nu
            n_con = self._sd0.n_con

            def body(carry, _):
                x, useq, u_prev, Y = carry
                u0, useq, Y, res = step_fn(x, useq, u_prev, Y)
                x_new = f_disc(x, u0)
                return (x_new, useq, u0, Y), (
                    x_new, u0, res.iters[0], res.converged[0])

            @jax.jit
            def run(x0):
                init = (x0, jnp.zeros((H, nu), jnp.float32),
                        jnp.zeros(nu, jnp.float32),
                        jnp.zeros((n_con, 1), jnp.float32))
                _, out = lax.scan(body, init, None, length=steps)
                return out

            self._rollout_fns[steps] = run
        xs, us, iters, conv = run(jnp.asarray(x0, jnp.float32))
        return dict(x=np.asarray(xs), u=np.asarray(us),
                    iters=np.asarray(iters), converged=np.asarray(conv))


def output_feedback_rollout(rti: RTIController, mhe, x_true0, steps: int,
                            w_seq=None, v_seq=None, u_warmup=None):
    """Fully-compiled output-feedback NONLINEAR MPC: moving-horizon
    estimation -> relinearize -> PQP solve -> apply, as one ``lax.scan``.

    The capstone composition of the nonlinear surface: the controller
    (:class:`RTIController`) and the estimator
    (:class:`~pqp_for_mpc_tpu.models.mhe.NonlinearMHE`) share the same
    discrete dynamics ``f_disc`` and the same relinearization machinery
    (:func:`~pqp_for_mpc_tpu.models.stagewise.relinearize`), so the whole
    closed loop — window estimate from the last ``N`` measurements, RTI
    control step from the estimate, true nonlinear propagation under
    process noise, noisy measurement — compiles into one XLA graph.
    The reference's pipeline reads its one state vector from a file
    (PQP_CPU.c:757-930); it has neither an estimator nor a loop.

    ``w_seq (steps + N, ns)`` / ``v_seq (steps + N, ny)``: process /
    measurement noise realizations (zeros when ``None``).  The first
    ``N`` steps run open loop (``u_warmup``, default zeros) to fill the
    estimation window; control starts at step ``N``.

    Returns dict of stacked trajectories over the ``steps`` controlled
    steps: ``x`` (true), ``x_hat`` (estimate the controller acted on),
    ``u``, ``iters_mhe``, ``iters_rti``, ``conv_mhe``, ``conv_rti``.
    """
    f_disc = rti.f_disc
    if mhe.f_disc is not f_disc:
        raise ValueError("controller and estimator must share f_disc "
                         "(same discrete dynamics)")
    N, ns, ny = mhe.window, mhe._ns, mhe._ny
    H, nu = rti._H, rti._nu
    C = mhe._C
    x_true0 = jnp.asarray(x_true0, jnp.float32)
    w_seq = (jnp.zeros((steps + N, ns), jnp.float32) if w_seq is None
             else jnp.asarray(w_seq, jnp.float32))
    v_seq = (jnp.zeros((steps + N, ny), jnp.float32) if v_seq is None
             else jnp.asarray(v_seq, jnp.float32))
    u_warm = (jnp.zeros((N, nu), jnp.float32) if u_warmup is None
              else jnp.asarray(u_warmup, jnp.float32).reshape(N, nu))
    rti_step = rti._make_step()

    @jax.jit
    def run(x0):
        # ---- warmup: fill the measurement window open loop
        def warm(x, inp):
            u, w, v = inp
            xn = f_disc(x, u) + w
            return xn, (xn, C @ xn + v)
        x_after, (xw, yw) = lax.scan(
            warm, x0, (u_warm, w_seq[:N], v_seq[:N]))
        # arrival prior = zero state (deliberately wrong: the arrival
        # correction must absorb it); callers wanting a better prior
        # pass longer records through NonlinearMHE.run directly.
        carry0 = (
            x_after,                                    # true state
            xw[0] * 0.0,                                # x_bar arrival
            u_warm, yw,                                 # window buffers
            jnp.zeros((N, ns), jnp.float32),            # W warm start
            jnp.full((mhe._sd0.n_con, 1), mhe.cfg.y0, jnp.float32),
            jnp.zeros((H, nu), jnp.float32),            # RTI plan
            jnp.zeros(nu, jnp.float32),                 # u_prev
            jnp.zeros((rti._sd0.n_con, 1), jnp.float32))

        def body(carry, inp):
            (x, x_bar, u_buf, y_buf, W, Ym, useq, u_prev, Yr) = carry
            w, v = inp
            xs, Wn, Ymn, res_m = mhe._window_core(x_bar, u_buf, y_buf,
                                                  W, Ym)
            x_hat = xs[-1]
            u0, useq, Yr, res_r = rti_step(x_hat, useq, u_prev, Yr)
            xn = f_disc(x, u0) + w
            yn = C @ xn + v
            u_buf2 = jnp.concatenate([u_buf[1:], u0[None]])
            y_buf2 = jnp.concatenate([y_buf[1:], yn[None]])
            W_next = jnp.concatenate([Wn[1:], Wn[-1:]])
            carry = (xn, xs[0], u_buf2, y_buf2, W_next, Ymn, useq, u0,
                     Yr)
            return carry, (xn, x_hat, u0, res_m.iters[0],
                           res_r.iters[0], res_m.converged[0],
                           res_r.converged[0])

        _, out = lax.scan(body, carry0,
                          (w_seq[N:N + steps], v_seq[N:N + steps]))
        return out

    xs, xh, us, im, ir, cm, cr = run(x_true0)
    return dict(x=np.asarray(xs), x_hat=np.asarray(xh), u=np.asarray(us),
                iters_mhe=np.asarray(im), iters_rti=np.asarray(ir),
                conv_mhe=np.asarray(cm), conv_rti=np.asarray(cr))
