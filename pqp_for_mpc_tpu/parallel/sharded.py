"""Sharded PQP solvers: data-parallel instance batches and model-parallel
(row-sharded dual Hessian) iteration.

The reference is strictly single-GPU (SURVEY.md §2.3); these are the new
scaling capabilities:

* :func:`shard_batch` + :func:`pqp_for_mpc_tpu.solver.solve_batched` —
  SPMD data parallelism: the batch (lane) axis of ``Y/Fd/Fp/Mp/Md`` is
  sharded over the ``data`` mesh axis, the small shared matrices are
  replicated, and XLA/GSPMD inserts the only needed collective (the
  ``all(done)`` reduction in the while-loop condition).  This is the path
  for 65k-scenario batches over several devices (BASELINE config 5).

* :func:`solve_row_sharded` — explicit shard_map tensor parallelism for
  large dual dimension N: each device owns a row block of
  ``Qd^{+/-}+theta`` (N/mp, N) and the matching block of Y; each iteration
  all-gathers Y along ``model`` (the TP matvec pattern), computes its row
  block of both matvecs, and applies the elementwise update to
  its rows.  Convergence reductions (Gp'Y, feasibility violations, dual
  cost) are ``psum`` partial sums.  U is recovered replicated (M is small).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pqp_for_mpc_tpu.config import SolverConfig
from pqp_for_mpc_tpu.problem import DualQP, PrimalQP
from pqp_for_mpc_tpu.solver import SolveResult, _as2d


def shard_batch(primal: PrimalQP, dual: DualQP, mesh: Mesh,
                axis: str = "data"):
    """Place a batched (primal, dual) pair on the mesh: batch axis sharded,
    instance-invariant matrices replicated.  Returns new pytrees; feed them
    to :func:`pqp_for_mpc_tpu.solver.solve_batched` and GSPMD handles the
    rest."""
    rep = NamedSharding(mesh, P())
    col = NamedSharding(mesh, P(None, axis))
    vec = NamedSharding(mesh, P(axis))

    def place(x, sh):
        return jax.device_put(x, sh)

    def place_batchlike(x):
        if x.ndim == 2:
            return place(x, col)
        if x.ndim == 1:
            return place(x, vec)
        return place(x, rep)

    primal = PrimalQP(
        Qp=place(primal.Qp, rep), Qp_inv=place(primal.Qp_inv, rep),
        Fp=place_batchlike(primal.Fp) if primal.Fp.ndim == 2 else place(primal.Fp, rep),
        Mp=place_batchlike(primal.Mp) if primal.Mp.ndim == 1 else place(primal.Mp, rep),
        Gp=place(primal.Gp, rep), Kp=place(primal.Kp, rep))
    dual = DualQP(
        Qd=place(dual.Qd, rep), theta=place(dual.theta, rep),
        Qdp_theta=(None if dual.Qdp_theta is None
                   else place(dual.Qdp_theta, rep)),
        Qdn_theta=(None if dual.Qdn_theta is None
                   else place(dual.Qdn_theta, rep)),
        Fd=place_batchlike(dual.Fd) if dual.Fd.ndim == 2 else place(dual.Fd, rep),
        Md=place_batchlike(dual.Md) if dual.Md.ndim == 1 else place(dual.Md, rep),
        Fdp=place_batchlike(dual.Fdp) if dual.Fdp.ndim == 2 else place(dual.Fdp, rep),
        Fdn=place_batchlike(dual.Fdn) if dual.Fdn.ndim == 2 else place(dual.Fdn, rep))
    return primal, dual


@partial(jax.jit, static_argnames=("cfg", "mesh", "data_axis",
                                   "model_axis", "mixed",
                                   "floor_frac", "floor_checks"))
def solve_row_sharded(primal: PrimalQP, dual: DualQP,
                      Y0: Optional[jax.Array] = None,
                      cfg: SolverConfig = SolverConfig(),
                      *, mesh: Mesh,
                      data_axis: str = "data",
                      model_axis: str = "model",
                      mixed: bool = False,
                      floor_frac: float = 0.25,
                      floor_checks: int = 2) -> SolveResult:
    """Tensor-parallel PQP solve with the dual dimension N row-sharded over
    ``model_axis`` and the batch sharded over ``data_axis``.

    Requires the MATERIALIZED Qd splits (each device holds its row
    blocks of them); rebuild with ``dualize(materialize_splits=True)``
    if the dual was built without.

    Requires N divisible by mesh.shape[model_axis] and B divisible by
    mesh.shape[data_axis] (pad the batch; pad N via the caller if needed —
    padded rows with identity diagonal and Y=1 are fixed points, see
    ops.solve_kernel).

    ``mixed=True`` prepends the bfloat16 bulk phase of
    :func:`pqp_for_mpc_tpu.solver.solve_mixed` in row-sharded form:
    each device streams its bf16 row blocks (half the bytes) AND the
    per-iteration ``all_gather(Y)`` moves bf16 (half the interconnect
    bytes — the TP matvec's collective is the other
    bandwidth term at scale).  Same consistent-rounding construction
    and bf16-floor handoff as solve_mixed; certification stays float32
    on the true problem.
    """
    prec = lax.Precision.HIGHEST if cfg.precision == "highest" else None
    N = dual.n_con
    mp = mesh.shape[model_axis]
    dp = mesh.shape[data_axis]
    Fd2 = _as2d(dual.Fd)
    B = Fd2.shape[1]
    if Y0 is None:
        Y0 = jnp.full((N, B), cfg.y0, jnp.float32)
    if N % mp or B % dp:
        raise ValueError(f"N={N} % model={mp} or B={B} % data={dp} != 0")
    if primal.Kp.ndim != 1:
        raise ValueError("solve_row_sharded requires instance-shared Kp; "
                         "use solve_batched for state-dependent bounds")

    Fp2 = _as2d(primal.Fp)
    if Fp2.shape[1] == 1 and B > 1:
        Fp2 = jnp.broadcast_to(Fp2, (Fp2.shape[0], B))
    Mp1d = jnp.broadcast_to(jnp.atleast_1d(primal.Mp), (B,))
    Md1d = jnp.broadcast_to(jnp.atleast_1d(dual.Md), (B,))
    if Fd2.shape[1] == 1 and B > 1:
        Fd2 = jnp.broadcast_to(Fd2, (N, B))
    Fdp2 = jnp.broadcast_to(_as2d(dual.Fdp), (N, B))
    Fdn2 = jnp.broadcast_to(_as2d(dual.Fdn), (N, B))

    bf16 = jnp.bfloat16
    if mixed:
        # consistent rounding (see solver.solve_mixed): ONE cast of Qd,
        # exact elementwise split, theta from the ROUNDED negative
        # rowsums, applied as a separate f32 diagonal term
        Qd_bf = dual.Qd.astype(bf16)
        Qdn_bf = jnp.maximum(-Qd_bf, 0)
        Qdp_bf = jnp.maximum(Qd_bf, 0)
        theta_mix = jnp.maximum(
            jnp.sum(Qdn_bf.astype(jnp.float32), axis=1), cfg.theta_floor)
    else:   # placeholders keep one inner signature (never read)
        Qd_bf = Qdn_bf = Qdp_bf = jnp.zeros((mp, 1), bf16)
        theta_mix = jnp.zeros((mp,), jnp.float32)

    k = cfg.check_every
    row = P(model_axis, None)          # row blocks of N x * matrices
    panel = P(model_axis, data_axis)   # (N, B) panels
    colp = P(None, data_axis)          # (M, B) panels
    bvec = P(data_axis)                # (B,) vectors
    repl = P()

    def inner(Qd_b, Qdn_b, Qdp_b, Fd_b, Fdp_b, Fdn_b, Kp_b, Gp_b,
              Qp, Qp_inv, Fp_l, Mp_l, Md_l, Y0_b,
              Qdbf_b, Qdnbf_b, Qdpbf_b, thm_b):
        Bl = Y0_b.shape[1]

        def gather(Yb):
            return lax.all_gather(Yb, model_axis, axis=0, tiled=True)

        def gather_bf(Yb):
            # the TP collective in bf16: half the interconnect bytes
            return lax.all_gather(Yb.astype(bf16), model_axis,
                                  axis=0, tiled=True)

        mm_bf = lambda Qb, Yf: jnp.matmul(
            Qb, Yf, preferred_element_type=jnp.float32)

        slack_b = Kp_b + jnp.maximum(cfg.erc * Kp_b, cfg.eac)

        def check(Yb):
            GtY = lax.psum(
                jnp.matmul(Gp_b.T, Yb, precision=prec), model_axis)   # (M,Bl)
            U = -jnp.matmul(Qp_inv, GtY + Fp_l, precision=prec)
            GpU_b = jnp.matmul(Gp_b, U, precision=prec)
            nviol = lax.psum(
                jnp.sum((GpU_b > slack_b[:, None]).astype(jnp.int32), axis=0),
                model_axis)
            feas = nviol == 0
            Yf = gather(Yb)
            QdY_b = jnp.matmul(Qd_b, Yf, precision=prec)
            Jd = lax.psum(0.5 * jnp.sum(Yb * QdY_b, axis=0)
                          + jnp.sum(Fd_b * Yb, axis=0), model_axis) \
                + 0.5 * Md_l
            Jp = (0.5 * jnp.sum(U * jnp.matmul(Qp, U, precision=prec), axis=0)
                  + jnp.sum(Fp_l * U, axis=0) + 0.5 * Mp_l)
            if cfg.gap_from_complementarity:
                # Y'(Qd Y + Fd) psum'd over row shards (identity and
                # conditioning rationale: SolverConfig docstring)
                gap = lax.psum(
                    jnp.sum(Yb * (QdY_b + Fd_b), axis=0), model_axis)
                weak = gap > 0.0
            else:
                gap = Jp + Jd
                weak = Jp > -Jd
            fail = (~feas | (gap > cfg.eaj)
                    | (gap / jnp.abs(Jd) > cfg.erj))
            if cfg.strict_weak_duality:
                fail = fail | weak
            # gap returned so the mixed phase's floor detector does not
            # re-pay the all_gather + f32 Qd matvec this check just did
            return ~fail, U, feas, Jp, Jd, gap

        def one_update(Yl, done):
            Yf = gather(Yl)
            num = jnp.matmul(Qdn_b, Yf, precision=prec) + Fdn_b
            den = jnp.matmul(Qdp_b, Yf, precision=prec) + Fdp_b
            if cfg.den_eps:
                den = jnp.maximum(den, cfg.den_eps)
            Yn = (num / den) * Yl
            return jnp.where(done[None, :], Yl, Yn)

        def accel_sh(Yb, done):
            """Row-sharded rendition of solver.accel_step: the direction
            and line-search quotients are psum partial reductions, with
            two extra all-gathers (p, Y_candidate) along model."""
            Yf = gather(Yb)
            grad_b = jnp.matmul(Qd_b, Yf, precision=prec) + Fd_b
            p_b = jnp.where((Yb > 0.0) | (grad_b < 0.0), -grad_b, 0.0)
            pf = gather(p_b)
            Qdp_full = jnp.matmul(Qd_b, pf, precision=prec)
            pQp = lax.psum(jnp.sum(p_b * Qdp_full, axis=0), model_axis)
            p2 = lax.psum(jnp.sum(p_b * p_b, axis=0), model_axis)
            alpha = jnp.where(pQp > 0, p2 / jnp.maximum(pQp, 1e-30), 0.0)
            Yn_b = jnp.maximum(Yb + alpha[None, :] * p_b, 0.0)
            fY = lax.psum(
                jnp.sum(0.5 * Yb * (grad_b + Fd_b), axis=0), model_axis)
            Ynf = gather(Yn_b)
            fYn = lax.psum(
                jnp.sum(0.5 * Yn_b * jnp.matmul(Qd_b, Ynf, precision=prec)
                        + Fd_b * Yn_b, axis=0), model_axis)
            keep = (fYn <= fY) & ~done
            return jnp.where(keep[None, :], Yn_b, Yb)

        def run_updates(Yb, done):
            if not cfg.accel_every:
                return lax.fori_loop(
                    0, k, lambda _, Y: one_update(Y, done), Yb)

            def chunk(_, Yc):
                Yc = lax.fori_loop(
                    0, cfg.accel_every,
                    lambda _, Y: one_update(Y, done), Yc)
                return accel_sh(Yc, done)
            return lax.fori_loop(0, k // cfg.accel_every, chunk, Yb)

        def global_unsolved(done):
            # count over both mesh axes so every device agrees on the trip
            return lax.psum(lax.psum(jnp.sum(~done), model_axis), data_axis)

        def local_bad(Yb, done):
            # divergence: non-finite anywhere in the (row-sharded) iterate
            nbad = lax.psum(jnp.sum((~jnp.isfinite(Yb)).astype(jnp.int32),
                                    axis=0), model_axis)
            return (nbad > 0) & ~done

        def cond(state):
            Yb, done, h, iters, div, unsolved = state
            return jnp.logical_and(unsolved > 0, h <= cfg.max_iters)

        def body(state):
            Yb, done, h, iters, div, _ = state
            ok, _, _, _, _, _ = check(Yb)
            bad = local_bad(Yb, done)
            newly = ok & ~done & ~bad
            iters = jnp.where(newly, h, iters)
            done = done | ok | bad
            div = div | bad
            Yb = run_updates(Yb, done)
            return (Yb, done, h + jnp.int32(k), iters, div,
                    global_unsolved(done))

        it_mix = jnp.zeros((Bl,), jnp.int32)
        Y_start = Y0_b
        if mixed:
            def upd_bf(Yl, frozen):
                Yf = gather_bf(Yl)
                tY = thm_b[:, None] * Yl
                num = mm_bf(Qdnbf_b, Yf) + tY + Fdn_b
                den = mm_bf(Qdpbf_b, Yf) + tY + Fdp_b
                if cfg.den_eps:
                    den = jnp.maximum(den, cfg.den_eps)
                return jnp.where(frozen[None, :], Yl, (num / den) * Yl)

            def accel_bf(Yb, frozen):
                Yf = gather_bf(Yb)
                grad_b = mm_bf(Qdbf_b, Yf) + Fd_b
                p_b = jnp.where((Yb > 0.0) | (grad_b < 0.0), -grad_b, 0.0)
                pf = gather_bf(p_b)
                pQp = lax.psum(jnp.sum(p_b * mm_bf(Qdbf_b, pf), axis=0),
                               model_axis)
                p2 = lax.psum(jnp.sum(p_b * p_b, axis=0), model_axis)
                alpha = jnp.where(pQp > 0,
                                  p2 / jnp.maximum(pQp, 1e-30), 0.0)
                Yn_b = jnp.maximum(Yb + alpha[None, :] * p_b, 0.0)
                fY = lax.psum(jnp.sum(0.5 * Yb * (grad_b + Fd_b), axis=0),
                              model_axis)
                Ynf = gather_bf(Yn_b)
                fYn = lax.psum(
                    jnp.sum(0.5 * Yn_b * mm_bf(Qdbf_b, Ynf)
                            + Fd_b * Yn_b, axis=0), model_axis)
                keep = (fYn <= fY) & ~frozen
                return jnp.where(keep[None, :], Yn_b, Yb)

            def run_bf(Yb, frozen):
                if not cfg.accel_every:
                    return lax.fori_loop(
                        0, k, lambda _, Y: upd_bf(Y, frozen), Yb)

                def chunk(_, Yc):
                    Yc = lax.fori_loop(
                        0, cfg.accel_every,
                        lambda _, Y: upd_bf(Y, frozen), Yc)
                    return accel_bf(Yc, frozen)
                return lax.fori_loop(0, k // cfg.accel_every, chunk, Yb)

            def cond_mx(state):
                Yb, frozen, h, it, slow, unsolved = state
                return jnp.logical_and(unsolved > 0, h <= cfg.max_iters)

            def body_mx(state):
                Yb, frozen, h, it, slow, _ = state
                ok, _, _, _, _, gap = check(Yb)
                g = jnp.abs(gap)
                g_bf = jnp.abs(lax.psum(jnp.sum(
                    Yb * (mm_bf(Qdbf_b, gather_bf(Yb)) + Fd_b),
                    axis=0), model_axis))
                bad = local_bad(Yb, frozen)
                slow = jnp.where(g_bf < floor_frac * g, slow + 1, 0)
                newly = (ok | bad | (slow >= floor_checks)) & ~frozen
                it = jnp.where(newly, h, it)
                frozen = frozen | newly
                Yb = run_bf(Yb, frozen)
                return (Yb, frozen, h + jnp.int32(k), it, slow,
                        global_unsolved(frozen))

            st = (Y0_b, jnp.zeros((Bl,), bool), jnp.int32(0), it_mix,
                  jnp.zeros((Bl,), jnp.int32), jnp.int32(1))
            Y_start, frz, h1, it_mix, _, _ = lax.while_loop(
                cond_mx, body_mx, st)
            it_mix = jnp.where(frz, it_mix, h1)
            # non-finite phase-1 lanes would poison the f32 warm start
            # (NaN is absorbing) — reset them to the cold start
            lane_ok = lax.psum(jnp.sum(
                (~jnp.isfinite(Y_start)).astype(jnp.int32), axis=0),
                model_axis) == 0
            Y_start = jnp.where(lane_ok[None, :], Y_start,
                                jnp.float32(cfg.y0))

        done0 = jnp.zeros((Bl,), bool)
        iters0 = jnp.zeros((Bl,), jnp.int32)
        div0 = jnp.zeros((Bl,), bool)
        state = (Y_start, done0, jnp.int32(1), iters0, div0, jnp.int32(1))
        Yb, done, h, iters, div, _ = lax.while_loop(cond, body, state)

        ok, U, feas, Jp, Jd, _ = check(Yb)
        bad = local_bad(Yb, done)
        div = div | bad
        newly = ok & ~done & ~bad
        iters = jnp.where(newly, h, iters)
        done = done | ok | bad
        iters = jnp.where(done, iters, h) + it_mix
        return SolveResult(U=U, Y=Yb, iters=iters, converged=done & ~div,
                           feasible=feas, Jp=Jp, Jd=Jd, diverged=div)

    fn = jax.shard_map(
        inner, mesh=mesh,
        in_specs=(row, row, row, panel, panel, panel,
                  P(model_axis), row, repl, repl, colp, bvec, bvec, panel,
                  row, row, row, P(model_axis)),
        out_specs=SolveResult(U=colp, Y=panel, iters=bvec, converged=bvec,
                              feasible=bvec, Jp=bvec, Jd=bvec,
                              diverged=bvec),
        check_vma=False)
    if dual.Qdn_theta is None:
        raise ValueError(
            "solve_row_sharded needs the MATERIALIZED Qd splits (each "
            "device holds its row blocks); rebuild the dual with "
            "dualize(materialize_splits=True)")
    return fn(dual.Qd, dual.Qdn_theta, dual.Qdp_theta, Fd2, Fdp2, Fdn2,
              primal.Kp, primal.Gp, primal.Qp, primal.Qp_inv,
              Fp2, Mp1d, Md1d, Y0,
              Qd_bf, Qdn_bf, Qdp_bf, theta_mix)
