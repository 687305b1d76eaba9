"""The PQP multiplicative-update dual solver.

Batched re-design of the reference hot loop (``solveQuadraticDual``,
PQP_CPU.c:694-750):

* the iteration is a ``lax.while_loop`` whose body performs
  ``check_every`` multiplicative updates followed by one convergence check
  — the update never reads the check's outputs (PQP_CPU.c:718-724), so the
  iterate trajectory is identical to the reference's check-every-iteration
  loop; only the *granularity* of the reported iteration count changes;
* instances are batched with the batch on the trailing (lane) axis:
  ``Y (N, B)``, so each update is two ``(N, N) @ (N, B)`` matrix products
  plus an elementwise multiply — the reference's per-element CUDA
  kernels (``updYCuda`` PQP_GPU_unoptimized.cu:358-376) dissolve into XLA
  fusions;
* per-instance convergence masks freeze solved instances
  (``jnp.where(done, Y, Y_next)``) — the batched analog of the reference's
  scalar early exit.

The whole-solve GPU kernel (:mod:`pqp_for_mpc_tpu.ops.solve_kernel`)
runs the same loop in one launch for small N.

Convergence test (``terminate``, PQP_CPU.c:673-687), reproduced exactly
including its quirks (slack uses ``erc*Kp`` with no absolute value,
PQP_CPU.c:338; costs in float32):

1. feasibility: ``Gp U <= Kp + max(erc*Kp, eac)`` elementwise;
2. weak duality: ``Jp <= -Jd``;
3. absolute gap:  ``Jp + Jd <= eaj``;
4. relative gap:  ``(Jp + Jd)/|Jd| <= erj``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from pqp_for_mpc_tpu.config import SolverConfig
from pqp_for_mpc_tpu.problem import DualQP, PrimalQP, _pytree_dataclass


@_pytree_dataclass
class SolveResult:
    """Per-instance solve outputs (batched shapes shown; single-instance
    calls squeeze the batch axis away)."""

    U: jax.Array           # (M, B) primal solution
    Y: jax.Array           # (N, B) dual solution
    iters: jax.Array       # (B,) int32 — reference-convention count: the
                           # value of h (starting at 1) at the first passing
                           # check, i.e. 1 + number of updates applied
                           # (PQP_CPU.c:714,739-741)
    converged: jax.Array   # (B,) bool
    feasible: jax.Array    # (B,) bool — constraint check at exit
    Jp: jax.Array          # (B,) primal cost at exit
    Jd: jax.Array          # (B,) dual cost at exit
    diverged: jax.Array = None  # (B,) bool — non-finite iterate detected
                                # (failure detection the reference lacks,
                                # SURVEY.md §5); None on legacy paths

    def stats(self) -> dict:
        """Structured solve observability (SURVEY.md §5: the reference
        only printf's the iteration count and costs).  Returns plain
        Python scalars/lists for logging."""
        import numpy as np
        gap = np.asarray(self.Jp) + np.asarray(self.Jd)
        jd = np.abs(np.asarray(self.Jd))
        return {
            "batch": int(np.asarray(self.iters).size),
            "converged": int(np.asarray(self.converged).sum()),
            "feasible": int(np.asarray(self.feasible).sum()),
            "iters_mean": float(np.asarray(self.iters).mean()),
            "iters_max": int(np.asarray(self.iters).max()),
            "gap_abs_max": float(np.abs(gap).max()),
            "gap_rel_max": float((np.abs(gap) / np.maximum(jd, 1e-30)).max()),
        }


def _as2d(v):
    return v if v.ndim == 2 else v[:, None]


def _mv(A, Y, precision):
    """Matrix-vector over the batch: A (N,N) or (B,N,N), Y (N,B) -> (N,B)."""
    if A.ndim == 2:
        return jnp.matmul(A, Y, precision=precision)
    return jnp.einsum("bij,jb->ib", A, Y, precision=precision)


def _mvT(A, Y, precision):
    """Transposed matrix-vector over the batch:
    A (N,M) or (B,N,M), Y (N,B) -> A' Y (M,B)."""
    if A.ndim == 2:
        return jnp.matmul(A.T, Y, precision=precision)
    return jnp.einsum("bij,ib->jb", A, Y, precision=precision)


def pqp_update(dual: DualQP, Y: jax.Array, precision=None,
               den_eps: float = 0.0) -> jax.Array:
    """One multiplicative update
    ``Y <- Y * ((Qd^- + th) Y + Fd^-) / ((Qd^+ + th) Y + Fd^+)``
    (updateY2 + updY, PQP_CPU.c:603-618, 590-596).  Y: (N, B).

    With ``dualize(materialize_splits=False)`` the splits are computed
    on the fly from ``Qd`` inside the dots (the geometry's memory
    halves; see dualize's docstring) with the theta
    term applied as a separate f32 elementwise add on BOTH sides.
    """
    if dual.Qdn_theta is None:
        tY = dual.theta.reshape(-1, 1) * Y
        num = _mv(jnp.maximum(-dual.Qd, 0.0), Y, precision) + tY \
            + _as2d(dual.Fdn)
        den = _mv(jnp.maximum(dual.Qd, 0.0), Y, precision) + tY \
            + _as2d(dual.Fdp)
    else:
        num = _mv(dual.Qdn_theta, Y, precision) + _as2d(dual.Fdn)
        den = _mv(dual.Qdp_theta, Y, precision) + _as2d(dual.Fdp)
    if den_eps:
        den = jnp.maximum(den, den_eps)
    return (num / den) * Y


def accel_step(dual: DualQP, Y: jax.Array, done: jax.Array,
               precision=None) -> jax.Array:
    """Projected steepest-descent step with exact line search on the dual
    objective ``f(Y) = 1/2 Y'Qd Y + Fd'Y`` over ``Y >= 0``.

    This is the corrected form of the reference's acceleration branch
    (computeph/computealphaY/updateY1, PQP_CPU.c:545-630): direction is the
    negative gradient masked to the feasible cone (the reference's computeph
    drops the Fd term — ``ph = -2 Qd Y``, PQP_CPU.c:621-626), the step is
    the exact Cayley quotient ``|p|^2 / p'Qd p`` (the reference damps it by
    10, PQP_GPU_optimized_coarsened.cu:825), the result is projected back to
    the nonnegative orthant, and the step is accepted per-instance only when
    it does not increase f — so the convergence guarantee of the
    multiplicative update is preserved.

    Unlike the multiplicative update, this step can move a multiplier OFF
    the absorbing state ``Y_i = 0`` (when grad_i < 0), which matters for
    warm-started receding-horizon solves whose active set shifts.
    """
    Fd = _as2d(dual.Fd)
    grad = _mv(dual.Qd, Y, precision) + Fd                      # (N, B)
    p = jnp.where((Y > 0.0) | (grad < 0.0), -grad, 0.0)
    pQp = jnp.sum(p * _mv(dual.Qd, p, precision), axis=0)       # (B,)
    alpha = jnp.where(pQp > 0,
                      jnp.sum(p * p, axis=0) / jnp.maximum(pQp, 1e-30), 0.0)
    Yn = jnp.maximum(Y + alpha[None, :] * p, 0.0)
    # f(Y) reuses grad: Qd Y = grad - Fd  =>  f = 1/2 sum Y*(grad + Fd)
    fY = 0.5 * jnp.sum(Y * (grad + Fd), axis=0)
    fYn = (0.5 * jnp.sum(Yn * _mv(dual.Qd, Yn, precision), axis=0)
           + jnp.sum(Fd * Yn, axis=0))
    keep = (fYn <= fY) & ~done
    return jnp.where(keep[None, :], Yn, Y)


def costs(primal: PrimalQP, dual: DualQP, Y: jax.Array, U: jax.Array,
          precision=None):
    """Batched primal/dual costs (computeCost, PQP_CPU.c:648-666):
    ``J = 1/2 Z'QZ + F'Z + M/2``.  Returns (Jp, Jd), each (B,)."""
    QdY = _mv(dual.Qd, Y, precision)
    Jd = (0.5 * jnp.sum(Y * QdY, axis=0)
          + jnp.sum(_as2d(dual.Fd) * Y, axis=0) + 0.5 * dual.Md)
    QpU = _mv(primal.Qp, U, precision)
    Jp = (0.5 * jnp.sum(U * QpU, axis=0)
          + jnp.sum(_as2d(primal.Fp) * U, axis=0) + 0.5 * primal.Mp)
    return Jp, Jd


def recover_U(primal: PrimalQP, Y: jax.Array, precision=None) -> jax.Array:
    """``U = -Qp^-1 (Fp + Gp' Y)`` (computeUfromY, PQP_CPU.c:352-360)."""
    tmp = _mvT(primal.Gp, Y, precision) + _as2d(primal.Fp)
    return -_mv(primal.Qp_inv, tmp, precision)


def feasibility(primal: PrimalQP, U: jax.Array, erc: float, eac: float,
                precision=None) -> jax.Array:
    """Elementwise-all feasibility with the reference's slack
    ``Kp + max(erc*Kp, eac)`` (compare, PQP_CPU.c:334-343 — note: no |Kp|,
    faithfully kept).  ``Kp`` may be ``(N,)`` or per-instance ``(N, B)``.
    Returns (B,) bool."""
    GpU = _mv(primal.Gp, U, precision)
    slack = primal.Kp + jnp.maximum(erc * primal.Kp, eac)
    return jnp.all(GpU <= _as2d(slack), axis=0)


def termination_fail(feas: jax.Array, Jp: jax.Array, Jd: jax.Array,
                     cfg: SolverConfig,
                     gap: Optional[jax.Array] = None) -> jax.Array:
    """The four-part verdict of ``terminate`` (PQP_CPU.c:673-687) given
    precomputed feasibility and costs.  Written in the reference's
    negated form (``fail if x > tol``) so NaN propagation matches C
    semantics (NaN comparisons are false => that test passes).  Single
    source of truth for the XLA check, the sharded check, and the
    whole-solve kernel's in-kernel check.

    ``gap`` — optional precomputed duality gap (the complementarity form
    ``Y'(Qd Y + Fd)``, see ``SolverConfig.gap_from_complementarity``);
    ``None`` uses the reference's explicit ``Jp + Jd``.  The weak-duality
    test keeps the reference's exact comparison form (``Jp > -Jd``) only
    in explicit mode — with a precomputed gap it is ``gap > 0``, the
    same predicate on the better-conditioned estimate.  NOTE (ADVICE r2
    #3): the complementarity estimator is nonnegative in exact
    arithmetic at feasible points, so under it ``strict_weak_duality``
    certifies only when float rounding lands the gap at or below zero —
    it adds essentially no slack beyond the two-sided gap tests and is
    best left False with a precomputed gap (MPC_CONFIG does)."""
    if gap is None:
        gap = Jp + Jd
        weak_fail = lambda: Jp > -Jd
    else:
        weak_fail = lambda: gap > 0.0
    fail = (~feas
            | (gap > cfg.eaj)
            | (gap / jnp.abs(Jd) > cfg.erj))
    if cfg.strict_weak_duality:
        fail = fail | weak_fail()
    return fail


def complementarity_gap(dual: DualQP, Y: jax.Array,
                        precision=None) -> jax.Array:
    """Duality gap of the recovered primal via the identity
    ``Jp(U(Y)) + Jd(Y) = Y'(Qd Y + Fd)`` — exact for
    ``U = -Qp^-1(Fp + Gp'Y)`` and numerically far better conditioned
    than the explicit difference (it never touches the Mp/Md constants;
    see ``SolverConfig.gap_from_complementarity``).  Returns (B,)."""
    QdY = _mv(dual.Qd, Y, precision)
    return jnp.sum(Y * (QdY + _as2d(dual.Fd)), axis=0)


def check_terminate(primal: PrimalQP, dual: DualQP, Y: jax.Array,
                    cfg: SolverConfig, precision=None):
    """The four-part test of ``terminate`` (PQP_CPU.c:673-687), batched.

    Returns (ok, U, feas, Jp, Jd).

    With ``cfg.feas_from_dual_gradient`` the feasibility residual is
    evaluated through the OPERATOR-CONSISTENT identity

        ``Gp U - Kp = -(Qd Y + Fd)``        (exact for the recovered U:
        substitute U = -Qp^-1(Fp + Gp'Y) and Qd/Fd's definitions,
        computeQd/computeFd PQP_CPU.c:440-460)

    so the certificate is measured at DUAL scale instead of re-deriving
    ``Gp @ (-Qp^-1(Fp + Gp'Y))`` at forcing scale, whose f32 noise
    (~eps * |Fp| * kappa-ish) floors the feasibility slack the
    condensed backend can certify.  This is the same telescoping trick
    the stage-wise path's split recovery uses (models/stagewise.py,
    round 3) — ported to the condensed backend (VERDICT r4 next #8).
    The dual gradient is shared with the complementarity gap, so the
    tighter certificate is also one matvec cheaper per check.
    """
    U = recover_U(primal, Y, precision)
    if cfg.feas_from_dual_gradient:
        QdY = _mv(dual.Qd, Y, precision)
        g = QdY + _as2d(dual.Fd)                    # = Kp - Gp U exactly
        slack = jnp.maximum(cfg.erc * primal.Kp, cfg.eac)
        feas = jnp.all(g >= -_as2d(slack), axis=0)
        Jd = (0.5 * jnp.sum(Y * QdY, axis=0)
              + jnp.sum(_as2d(dual.Fd) * Y, axis=0) + 0.5 * dual.Md)
        QpU = _mv(primal.Qp, U, precision)
        Jp = (0.5 * jnp.sum(U * QpU, axis=0)
              + jnp.sum(_as2d(primal.Fp) * U, axis=0) + 0.5 * primal.Mp)
        gap = (jnp.sum(Y * g, axis=0)
               if cfg.gap_from_complementarity else None)
    else:
        feas = feasibility(primal, U, cfg.erc, cfg.eac, precision)
        Jp, Jd = costs(primal, dual, Y, U, precision)
        gap = (complementarity_gap(dual, Y, precision)
               if cfg.gap_from_complementarity else None)
    fail = termination_fail(feas, Jp, Jd, cfg, gap)
    return ~fail, U, feas, Jp, Jd


def merge_lanes(ok, res_a, res_b):
    """Per-lane select between two :class:`SolveResult`s (or any pytrees
    of ``(.., B)`` / ``(B,)`` arrays): lane ``i`` takes ``res_a`` where
    ``ok[i]`` else ``res_b`` — the certify-or-recover merge."""
    def pick(a, b):
        m = ok[None, :] if a.ndim == 2 else ok
        return jnp.where(m, a, b)
    return jax.tree.map(pick, res_a, res_b)


def retry_cold_solve(solve_fn, Y_warm: jax.Array,
                     Y_cold: jax.Array) -> SolveResult:
    """Certify-or-recover with ONE compiled solve instance.

    ``solve_fn: Y0 (N, B) -> SolveResult``.  Attempt 0 solves from
    ``Y_warm``; when any lane fails the four-part certification, a second
    attempt re-enters the SAME graph with a per-lane ``Y0`` — certified
    lanes keep their solution (they re-certify at the first check),
    failed lanes reset to ``Y_cold`` — and the results merge per lane.

    The attempt loop is a ``lax.while_loop``, so the solve graph is
    compiled ONCE and the second attempt exists only at runtime (and
    only when taken).  A ``lax.cond`` whose cold branch duplicates the
    whole while-loop-of-associative-scan solve graph compiles twice the
    graph, which at H=512 is minutes.

    ``iters``/costs of a retried lane report the attempt that produced
    its result (same semantics the ``lax.cond`` form had).
    """
    dummy = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         jax.eval_shape(solve_fn, Y_warm))

    def cond(state):
        attempt, res = state
        return jnp.logical_and(attempt < 2, ~jnp.all(res.converged))

    def body(state):
        attempt, res = state
        Y0 = jnp.where(attempt == 0, Y_warm,
                       jnp.where(res.converged[None, :], res.Y, Y_cold))
        out = solve_fn(Y0)
        # attempt 0: dummy.converged is all-False, so the merge passes
        # `out` through verbatim
        return attempt + 1, merge_lanes(res.converged, res, out)

    _, merged = lax.while_loop(cond, body, (jnp.int32(0), dummy))
    return merged


@partial(jax.jit, static_argnames=("cfg", "retry_cold"))
def solve_batched(primal: PrimalQP, dual: DualQP,
                  Y0: Optional[jax.Array] = None,
                  cfg: SolverConfig = SolverConfig(),
                  retry_cold: bool = False) -> SolveResult:
    """Solve a batch of PQP instances sharing constraint geometry.

    ``primal.Fp`` / ``dual.Fd`` may be ``(M,)``/``(N,)`` (one instance) or
    ``(M, B)``/``(N, B)`` (a batch over initial states / disturbances —
    Qd and its splits are shared because they depend only on Gp and Qp,
    which is what makes the batch a single GEMM).  For batches of fully
    distinct instances, stack Qd as ``(B, N, N)`` (einsum path) or use
    :func:`jax.vmap` over :func:`solve`.

    ``Y0`` enables warm starting (receding-horizon MPC); defaults to the
    reference's cold start ``Y = y0 * ones`` (PQP_CPU.c:710).

    ``retry_cold`` (requires a warm ``Y0``): any lane that fails the
    four-part certification is re-solved once from the cold start inside
    the same dispatch (:func:`retry_cold_solve`) — no host sync, no
    duplicated solve graph.
    """
    N = dual.n_con
    B = _as2d(dual.Fd).shape[1] if dual.Fd.ndim == 2 else 1
    if dual.Qd.ndim == 3:
        B = dual.Qd.shape[0]
    warm = Y0 is not None
    if Y0 is None:
        Y0 = jnp.full((N, B), cfg.y0, dtype=jnp.float32)
    else:
        Y0 = _as2d(Y0)
        if Y0.shape[1] == 1 and B > 1:
            # a single warm start seeds the whole batch
            Y0 = jnp.broadcast_to(Y0, (N, B))
        elif B == 1 and Y0.shape[1] > 1:
            B = Y0.shape[1]
        elif Y0.shape[1] != B:
            raise ValueError(
                f"warm start batch {Y0.shape[1]} != instance batch {B}")

    if retry_cold and warm:
        Y_cold = jnp.full((N, B), cfg.y0, dtype=jnp.float32)
        return retry_cold_solve(
            lambda y0: _solve_core(primal, dual, y0, cfg), Y0, Y_cold)
    return _solve_core(primal, dual, Y0, cfg)


def _solve_core(primal: PrimalQP, dual: DualQP, Y0: jax.Array,
                cfg: SolverConfig) -> SolveResult:
    """The masked-lane while loop on a normalized ``Y0 (N, B)``."""
    prec = lax.Precision.HIGHEST if cfg.precision == "highest" else None
    N = dual.n_con
    B = Y0.shape[1]
    k = cfg.check_every

    def run_mult_updates(Y, done, n):
        def body(_, Yc):
            Yn = pqp_update(dual, Yc, prec, cfg.den_eps)
            return jnp.where(done[None, :], Yc, Yn)

        return lax.fori_loop(0, n, body, Y)

    def run_updates(Y, done):
        if not cfg.accel_every:
            return run_mult_updates(Y, done, k)
        # chunks of accel_every multiplicative updates, each followed by
        # one safeguarded projected-gradient step (check_every divisible
        # by accel_every, enforced in SolverConfig).
        def chunk(_, Yc):
            Yc = run_mult_updates(Yc, done, cfg.accel_every)
            return accel_step(dual, Yc, done, prec)
        return lax.fori_loop(0, k // cfg.accel_every, chunk, Y)

    def cond(state):
        Y, done, h, iters, div = state
        return jnp.logical_and(~jnp.all(done), h <= cfg.max_iters)

    def body(state):
        Y, done, h, iters, div = state
        ok, _, _, _, _ = check_terminate(primal, dual, Y, cfg, prec)
        # divergence detection (reference has none, SURVEY.md §5): a
        # non-finite iterate can never recover under the multiplicative
        # update — freeze the lane instead of spinning to max_iters.
        bad = ~jnp.all(jnp.isfinite(Y), axis=0) & ~done
        newly = ok & ~done & ~bad
        # stamp the freeze iteration for bad lanes too, so stats() reports
        # how long a diverged lane actually ran instead of 0
        iters = jnp.where(newly | bad, h, iters)
        done = done | ok | bad
        div = div | bad
        Y = run_updates(Y, done)
        return (Y, done, h + jnp.int32(k), iters, div)

    done0 = jnp.zeros((B,), dtype=bool)
    iters0 = jnp.zeros((B,), dtype=jnp.int32)
    div0 = jnp.zeros((B,), dtype=bool)
    Y, done, h, iters, div = lax.while_loop(
        cond, body, (Y0, done0, jnp.int32(1), iters0, div0))

    # Final check so exit diagnostics reflect the returned iterate even for
    # instances that hit max_iters.
    ok, U, feas, Jp, Jd = check_terminate(primal, dual, Y, cfg, prec)
    bad = ~jnp.all(jnp.isfinite(Y), axis=0)
    newly_bad = bad & ~done
    div = div | newly_bad
    newly = ok & ~done & ~bad
    iters = jnp.where(newly | newly_bad, h, iters)
    done = done | ok | bad
    iters = jnp.where(done, iters, h)
    return SolveResult(U=U, Y=Y, iters=iters, converged=done & ~div,
                       feasible=feas, Jp=Jp, Jd=Jd, diverged=div)


def solve_mixed(primal: PrimalQP, dual: DualQP,
                Y0: Optional[jax.Array] = None,
                cfg: SolverConfig = SolverConfig(),
                floor_frac: float = 0.25,
                floor_checks: int = 2) -> SolveResult:
    """Mixed-precision solve for large N: a bfloat16 bulk phase runs
    its matrix products on bfloat16 operands with float32 accumulation
    (half the bytes of each ``Qd`` sweep, and the bf16 matrix rate),
    then :func:`solve_batched` refines in float32 from the bf16 iterate
    to the full certification tolerances.  The result is certified on
    the TRUE float32 problem — bf16 only accelerates the journey, never
    the verdict.  Which of the two it buys on a given card is an open
    measurement.

    Correctness requires a CONSISTENT bf16 problem.  Rounding the two
    precomputed splits ``Qd^{+/-} + theta`` independently breaks the
    identity ``Qd = (Qd^+ + th) - (Qd^- + th)`` and the multiplicative
    update DIVERGES (Y grows without bound and no f32 refine recovers —
    the iterate lands on the wrong active face and 0 is absorbing).  Instead ``Qd`` is rounded ONCE to bfloat16,
    split elementwise (exact: the split just masks signs), theta is
    recomputed in f32 from the ROUNDED negative part's rowsums (the
    reference rule, PQP_CPU.c:503-519, so dominance still holds for the
    rounded matrix) and applied as a separate f32 elementwise term.
    Phase 1 is then an exact PQP iteration for the perturbed problem —
    monotone as ever — whose fixed point sits O(|Qd| * 2^-8) from the
    true one.

    Phase 1 exits per lane on certification (float32
    :func:`check_terminate` on the true problem) or at the bf16 FLOOR,
    detected by comparing the gap of the BF16 problem itself (one cheap
    bf16 matvec, ``g_bf = Y'(Qd_bf Y + Fd)``) against the true gap:
    away from the bf16 fixed point the two track each other, while AT the fixed
    point ``g_bf -> 0`` and the true gap pins to the perturbation floor
    — so ``g_bf < floor_frac * g_true`` for ``floor_checks``
    consecutive checks means further bf16 sweeps improve only the
    perturbed problem and the lane hands off to float32.  PROGRESS-rate
    stall detectors do not work here: the PQP gap trajectory has long
    mid-solve plateaus (active-set resolution) that are
    indistinguishable from a floor locally — a per-check ratio test
    froze every lane long before the productive bf16 iterations were
    spent.  Phase 2 warm-starts :func:`solve_batched`.  Reported
    ``iters`` = phase-1 iterations at freeze + phase-2 iterations, so
    throughput accounting stays honest.

    ``cfg.max_iters`` caps EACH phase separately (the reported
    per-lane ``iters`` is the honest sum and may exceed it).  Non-finite phase-1
    lanes are reset to the cold start before the refine — divergence in
    the bulk phase costs time, never the verdict.

    Accepts shared geometry (2-D ``Qd``, batch = forcing lanes) and
    DISTINCT per-instance geometry (3-D ``Qd (B, N, N)``, the einsum
    path — theta then comes from each instance's own rounded rowsums).
    For small N the matrix products are not the cost and this path buys
    nothing.  Call it under ``jit``: the bf16 geometry otherwise
    re-materializes per call.
    """
    distinct = dual.Qd.ndim == 3        # per-instance geometry (B, N, N)
    prec = lax.Precision.HIGHEST if cfg.precision == "highest" else None
    N = dual.n_con
    B = dual.Qd.shape[0] if distinct else _as2d(dual.Fd).shape[1]
    if Y0 is None:
        Y0 = jnp.full((N, B), cfg.y0, dtype=jnp.float32)
    else:
        Y0 = _as2d(Y0)
        if Y0.shape[1] == 1 and B > 1:
            Y0 = jnp.broadcast_to(Y0, (N, B))
        elif not distinct:
            B = Y0.shape[1]

    bf16 = jnp.bfloat16
    Qd_bf = dual.Qd.astype(bf16)
    Qdn_bf = jnp.maximum(-Qd_bf, 0)
    Qdp_bf = jnp.maximum(Qd_bf, 0)
    # rowsums of the ROUNDED negative part, (N,) or per-instance (B, N)
    rs = jnp.sum(Qdn_bf.astype(jnp.float32), axis=-1)
    theta = jnp.maximum(rs.T if distinct else rs[:, None],
                        cfg.theta_floor)
    Fdn = jnp.broadcast_to(_as2d(dual.Fdn), (N, B))
    Fdp = jnp.broadcast_to(_as2d(dual.Fdp), (N, B))
    Fd = _as2d(dual.Fd)
    if distinct:
        dot_bf = lambda Qb, Y: jnp.einsum(
            "bij,jb->ib", Qb, Y.astype(bf16),
            preferred_element_type=jnp.float32)
    else:
        dot_bf = lambda Qb, Y: jnp.dot(Qb, Y.astype(bf16),
                                       preferred_element_type=jnp.float32)

    def upd(Y):
        tY = theta * Y
        num = dot_bf(Qdn_bf, Y) + tY + Fdn
        den = dot_bf(Qdp_bf, Y) + tY + Fdp
        if cfg.den_eps:
            den = jnp.maximum(den, cfg.den_eps)
        return (num / den) * Y

    def accel_bf(Y, frozen):
        # accel_step on the bf16 problem (same safeguarded algebra)
        grad = dot_bf(Qd_bf, Y) + Fd
        p = jnp.where((Y > 0.0) | (grad < 0.0), -grad, 0.0)
        pQp = jnp.sum(p * dot_bf(Qd_bf, p), axis=0)
        alpha = jnp.where(pQp > 0,
                          jnp.sum(p * p, axis=0)
                          / jnp.maximum(pQp, 1e-30), 0.0)
        Yn = jnp.maximum(Y + alpha[None, :] * p, 0.0)
        fY = 0.5 * jnp.sum(Y * (grad + Fd), axis=0)
        fYn = (0.5 * jnp.sum(Yn * dot_bf(Qd_bf, Yn), axis=0)
               + jnp.sum(Fd * Yn, axis=0))
        keep = (fYn <= fY) & ~frozen
        return jnp.where(keep[None, :], Yn, Y)

    k = cfg.check_every

    def run_updates(Y, frozen):
        def mult(n, Yc):
            def body(_, Yi):
                return jnp.where(frozen[None, :], Yi, upd(Yi))
            return lax.fori_loop(0, n, body, Yc)
        if not cfg.accel_every:
            return mult(k, Y)

        def chunk(_, Yc):
            return accel_bf(mult(cfg.accel_every, Yc), frozen)
        return lax.fori_loop(0, k // cfg.accel_every, chunk, Y)

    def true_gap(Y, Jp, Jd):
        if cfg.gap_from_complementarity:
            return complementarity_gap(dual, Y, prec)
        return Jp + Jd

    def cond(state):
        Y, frozen, h, iters, slow = state
        return jnp.logical_and(~jnp.all(frozen), h <= cfg.max_iters)

    def body(state):
        Y, frozen, h, iters, slow = state
        ok, _, _, Jp, Jd = check_terminate(primal, dual, Y, cfg, prec)
        g = jnp.abs(true_gap(Y, Jp, Jd))
        g_bf = jnp.abs(jnp.sum(Y * (dot_bf(Qd_bf, Y) + Fd), axis=0))
        bad = ~jnp.all(jnp.isfinite(Y), axis=0) & ~frozen
        slow = jnp.where(g_bf < floor_frac * g, slow + 1, 0)
        at_floor = slow >= floor_checks
        newly = (ok | bad | at_floor) & ~frozen
        iters = jnp.where(newly, h, iters)
        frozen = frozen | newly
        Y = run_updates(Y, frozen)
        return (Y, frozen, h + jnp.int32(k), iters, slow)

    frozen0 = jnp.zeros((B,), bool)
    iters0 = jnp.zeros((B,), jnp.int32)
    slow0 = jnp.zeros((B,), jnp.int32)
    Y1, frozen, h, it1, _ = lax.while_loop(
        cond, body, (Y0, frozen0, jnp.int32(0), iters0, slow0))
    it1 = jnp.where(frozen, it1, h)

    # a lane that went non-finite in phase 1 would poison its f32 warm
    # start forever (NaN/Inf are absorbing under the multiplicative
    # update) — reset such lanes to the cold start so phase 2 can still
    # solve them from scratch
    lane_ok = jnp.all(jnp.isfinite(Y1), axis=0)
    Y1 = jnp.where(lane_ok[None, :], Y1, jnp.float32(cfg.y0))

    res = solve_batched(primal, dual, Y0=Y1, cfg=cfg)
    return dataclasses.replace(res, iters=res.iters + it1)


def solve(primal: PrimalQP, dual: Optional[DualQP] = None,
          Y0: Optional[jax.Array] = None,
          cfg: SolverConfig = SolverConfig()) -> SolveResult:
    """Single-instance convenience wrapper: dualizes if needed, solves,
    and squeezes the batch axis (mirrors main(), PQP_CPU.c:994-999).

    Rejects batched inputs — use :func:`solve_batched` for those (returning
    lane 0 silently would be a quiet wrong answer)."""
    for name, arr in (("Fp", primal.Fp), ("Kp", primal.Kp),
                      ("Y0", Y0), ("Fd", None if dual is None else dual.Fd)):
        if arr is not None and arr.ndim == 2 and arr.shape[1] > 1:
            raise ValueError(
                f"solve() is single-instance but {name} has batch "
                f"{arr.shape[1]}; use solve_batched()")
    if dual is None:
        from pqp_for_mpc_tpu.dual import dualize
        dual = dualize(primal, theta_floor=cfg.theta_floor,
                       precision=cfg.precision)
    res = solve_batched(primal, dual, Y0=Y0, cfg=cfg)
    squeeze = lambda a: a[..., 0] if a.ndim >= 1 and a.shape[-1] == 1 else a
    return SolveResult(
        U=res.U[:, 0], Y=res.Y[:, 0], iters=squeeze(res.iters),
        converged=squeeze(res.converged), feasible=squeeze(res.feasible),
        Jp=squeeze(res.Jp), Jd=squeeze(res.Jd),
        diverged=squeeze(res.diverged))
