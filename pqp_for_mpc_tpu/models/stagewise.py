"""Sparse (non-condensed) stage-wise PQP for long horizons.

The condensed formulation (models/mpc.py, mirroring the reference's
precomputed blocks, PQP_CPU.c:757-930) densifies at O((H*nu)^2): the
dual Hessian ``Qd = Gp Qp^-1 Gp'`` is a dense (4*H*nu)^2 matrix (the
reference hard-wires pHorizon=1 to dodge this, PQP_CPU.c:13-17).  This
module runs the SAME PQP algorithm with O(H) memory and O(H) work per
iteration by never materializing Qp, Qp^-1 or Qd:

* ``Qp^-1 v`` is an unconstrained LQR solve — a Riccati-factored
  backward/forward pair of ``lax.scan``s over stages (the classic
  banded-KKT elimination, expressed as scans with ``(ns, B)`` carries
  so every step is a small matrix product over the batch);
* ``Qd Y = G Qp^-1 (G' Y)`` where G (box + slew rows, the layout of
  models/mpc.py input_constraints) is applied as shifts/sign-flips;
* the PQP multiplicative update needs the ELEMENTWISE split
  ``Qd = Qd^+ - Qd^-`` — the one object that seems to force a dense
  Qd.  It does not: with any elementwise bound ``D >= |Qd|``,

      P = (D + Qd)/2 + diag(theta),  N = (D - Qd)/2 + diag(theta)

  is an elementwise-nonnegative split with ``P - N = Qd`` whose
  matvecs need one ``Qd Y`` apply plus one ``D Y`` apply.  The
  **banded-exact hybrid** D (see :class:`StagewiseDual`): within
  ``band`` stages of the diagonal, D carries ``|Qd|`` EXACTLY (all 16
  group-blocks of Qd are signed copies of four base blocks derived
  from ``Qp^-1``, whose dense columns the build already computes for
  the radii); off-band it falls back to the rank-1 Cauchy-Schwarz
  bound ``|Qd_ij| <= r_i r_j``, ``r_i = sqrt(Qd_ii)`` (with
  ``Qd = W W'``, W = G L^-T), whose matvec is ``r (r'Y)`` minus its
  in-band window.  The off-band tail decays like the closed-loop
  dynamics (Qp^-1 is the input block of a banded KKT inverse), so a
  narrow band makes D ~ |Qd| and the contraction matches the condensed
  reference split (at ``band = H-1`` exactly, to float noise).
  ``theta_i = max(rowsum(N)_i, floor)`` dominates the reference's
  ``rowsum(Qd^-)`` rule (PQP_CPU.c:503-519) since ``N >= Qd^-``
  elementwise, so the update keeps the PQP monotonicity guarantee.
  (Round 2 used the pure rank-1 split — D = r r' everywhere — which
  cost 15.7x the condensed iterations at H=32; the hybrid closes
  that gap.)

Cross-checks: matches the condensed solver's U* on the same MPCSpec
(tests/test_stagewise.py) at H <= 50; scales to H = 512 with memory
linear in H.

**Temporal parallelization** (``pscan``): every stage recursion here
(Riccati backward adjoint, forward rollout, forcing adjoint) is a
composition of affine maps ``x -> M_k x + c_k``, and affine composition
is associative — so each depth-H ``lax.scan`` has an equivalent
O(log H)-depth ``lax.associative_scan`` (Sarkka & Garcia-Fernandez,
"Temporal parallelization of dynamic programming and linear quadratic
control", IEEE TAC 2021).  This converts the per-PQP-iteration KKT
solve from 2H latency-bound tiny-matmul steps into ~log2(H) rounds of
batched ``(H, ns, ns)`` einsums.
``solve_stagewise(pscan=None)`` auto-enables it at H >= 64.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from pqp_for_mpc_tpu.config import SolverConfig
from pqp_for_mpc_tpu.models.mpc import MPCSpec
from pqp_for_mpc_tpu.problem import _pytree_dataclass
from pqp_for_mpc_tpu.solver import SolveResult


@_pytree_dataclass(meta_fields=("H", "ns", "nu", "ny"))
class StagewiseFactor:
    """Riccati factorization of the stage-wise primal Hessian Qp (the
    implicit analog of the reference's one-time Gauss_Jordan inverse,
    PQP_CPU.c:251-326): time-varying gains such that ``Qp^-1 v`` is one
    backward + one forward scan.

    Plant matrices are stored STACKED per stage ``(H, ...)`` — an LTI
    :class:`~pqp_for_mpc_tpu.models.plants.LinearPlant` is broadcast at
    build time, an :class:`~pqp_for_mpc_tpu.models.plants.LTVPlant`
    keeps its per-stage matrices — so there is exactly one code path
    for both (the pscan forms materialize (H, ...) operands anyway, and
    the sequential scans just consume them as scan inputs).  The
    reference is convention ``x_{k+1} = A[k] x_k + B[k] u_k``, output
    slot k = ``C[k] x_{k+1}``, tracking target ``r[k]``."""

    A: jax.Array        # (H, ns, ns)
    Bm: jax.Array       # (H, ns, nu)
    E: jax.Array        # (H, ns, nd)
    C: jax.Array        # (H, ny, ns)
    Qy: jax.Array       # (H, ny, ny) per-stage tracking weights
    R: jax.Array        # (H, nu, nu) per-stage input weights
    P: jax.Array        # (ns, ns) terminal state weight (zeros = none)
    r: jax.Array        # (H, ny)
    K: jax.Array        # (H, nu, ns)   feedback gains
    Hinv: jax.Array     # (H, nu, nu)   (R + B'P_{k+1}B)^-1
    W: jax.Array        # (H, ns, nu)   P_{k+1} B Hinv_k
    H: int = 0
    ns: int = 0
    nu: int = 0
    ny: int = 0


def _a_shift(f: StagewiseFactor) -> jax.Array:
    """``Ash[k] = A[k+1]`` (zero at k = H-1): the state-to-costate
    propagation entering output slot k comes from the NEXT stage's
    dynamics; the last slot has nothing downstream."""
    return jnp.concatenate([f.A[1:], jnp.zeros_like(f.A[:1])], axis=0)


def riccati_factor(spec: MPCSpec) -> StagewiseFactor:
    """Backward Riccati recursion for the stage costs
    ``sum_{k=1..H} |C_k x_k - r_k|^2_Qy + sum_k |u_k|^2_R`` (the
    tracking cost of models/mpc.py).  O(H) scan of small dense ops.
    Accepts LTI and LTV plants (2-D matrices broadcast to per-stage
    stacks) and a constant ``(ny,)`` or per-stage ``(H, ny)`` reference.
    """
    plant, H = spec.plant, spec.horizon
    ltv = np.asarray(plant.A).ndim == 3
    if ltv and plant.A.shape[0] != H:
        raise ValueError(
            f"LTV plant horizon {plant.A.shape[0]} != spec horizon {H}")
    stk = (lambda m: jnp.asarray(m, jnp.float32)) if ltv else \
        (lambda m: jnp.broadcast_to(
            jnp.asarray(m, jnp.float32), (H,) + np.asarray(m).shape))
    A, B, E, C = stk(plant.A), stk(plant.B), stk(plant.E), stk(plant.C)
    ny, ns, nu = C.shape[1], A.shape[1], B.shape[2]
    Qy = jnp.asarray(spec.Qy, jnp.float32)
    Qy = jnp.broadcast_to(Qy, (H, ny, ny)) if Qy.ndim == 2 else Qy
    if Qy.shape != (H, ny, ny):
        raise ValueError(f"Qy shape {Qy.shape} != ({H}, {ny}, {ny})")
    R = jnp.asarray(spec.R, jnp.float32)
    R = jnp.broadcast_to(R, (H, nu, nu)) if R.ndim == 2 else R
    if R.shape != (H, nu, nu):
        raise ValueError(f"R shape {R.shape} != ({H}, {nu}, {nu})")
    P = (jnp.zeros((ns, ns), jnp.float32) if spec.P is None
         else jnp.asarray(spec.P, jnp.float32))
    r = jnp.asarray(spec.r, jnp.float32)
    if r.ndim == 1:
        r = jnp.broadcast_to(r, (H, ny))
    elif r.shape != (H, ny):
        raise ValueError(f"reference shape {r.shape} != ({H}, {ny})")
    return _riccati_core(A, B, E, C, Qy, R, r, P)


def _riccati_core(A, B, E, C, Qy, R, r, P=None) -> StagewiseFactor:
    """The recursion on validated stacked ``(H, ...)`` arrays — pure
    jnp, traceable: the :func:`relinearize` hot path runs this under
    jit every control step.  ``Qy (H, ny, ny)``/``R (H, nu, nu)`` are
    per-stage weight stacks; ``P (ns, ns)`` the terminal state weight
    (None/zeros = no terminal term).
    """
    H, ny = C.shape[0], C.shape[1]
    if P is None:
        P = jnp.zeros((A.shape[1], A.shape[1]), jnp.float32)
    # Reference cost convention (models/mpc.py): J = sum (y-r)'Qy(y-r)
    # + u'Ru + x_H'P x_H = 1/2 U'Qp U + Fp'U + 1/2 Mp, i.e. Qp =
    # 2*(Su'Qbar Su + Rbar).  The Riccati recursion therefore runs on
    # the DOUBLED stage weights so kkt_solve applies the reference's
    # Qp^-1 exactly; Qy/R/P are stored unscaled for cost evaluation.
    Qt = 2.0 * jnp.einsum("hji,hjk,hkl->hil", C, Qy, C)  # (H, ns, ns)
    R2 = 2.0 * R
    # The carry entering the step that emits stage k's gains is
    # Pbar_{k+1} = Hessian of [arrival cost at x_{k+1} + cost-to-go];
    # the NEXT carry adds the arrival cost AT x_k, i.e. Qt[k-1] (in the
    # LTI special case Qt is constant and this collapses to the
    # textbook P_new = Qt + A'PA - ...).  The terminal weight rides the
    # scan init: the cost-to-go entering stage H-1 is Qt[-1] + 2P.
    Qt_prev = jnp.concatenate([jnp.zeros_like(Qt[:1]), Qt[:-1]], axis=0)

    def step(Pc, inp):
        # Pc = Pbar_{k+1}; emit gains for stage k
        Ak, Bk, R2k, Qkm1 = inp
        BtP = Bk.T @ Pc
        Hk = R2k + BtP @ Bk
        Hinv = jnp.linalg.inv(Hk)
        K = Hinv @ BtP @ Ak
        W = Pc @ Bk @ Hinv
        P_new = Qkm1 + Ak.T @ Pc @ Ak - Ak.T @ Pc @ Bk @ K
        P_new = 0.5 * (P_new + P_new.T)   # keep symmetric
        return P_new, (K, Hinv, W)

    with jax.default_matmul_precision("highest"):
        _, (K, Hinv, W) = lax.scan(
            step, Qt[-1] + 2.0 * P,
            (A[::-1], B[::-1], R2[::-1], Qt_prev[::-1]))
    # scan emitted k = H-1 .. 0; store in forward order
    K = K[::-1]
    Hinv = Hinv[::-1]
    W = W[::-1]
    return StagewiseFactor(A=A, Bm=B, E=E, C=C, Qy=Qy, R=R, P=P, r=r,
                           K=K, Hinv=Hinv, W=W, H=H,
                           ns=A.shape[1], nu=B.shape[2], ny=ny)


def _affine_cumulative(Ms: jax.Array, cs: jax.Array, precision=None):
    """Inclusive :func:`lax.associative_scan` of affine maps
    ``x -> M_i x + c_i`` along axis 0: position ``i`` holds the
    composition of steps ``0..i`` (step 0 applied first).

    This is the temporal-parallelization primitive (Sarkka &
    Garcia-Fernandez, IEEE TAC 2021: LQR/Kalman recursions are
    compositions of affine maps, and affine-map composition is
    associative): a depth-H sequential recursion becomes log2(H)
    rounds of batched ``(H, n, n)`` einsums instead of H latency-bound
    steps.  ``Ms (H, n, n)``, ``cs (H, n, B)``."""
    def comb(a, b):
        Ma, ca = a
        Mb, cb = b
        M = jnp.einsum("...ij,...jk->...ik", Mb, Ma, precision=precision)
        c = jnp.einsum("...ij,...jb->...ib", Mb, ca,
                       precision=precision) + cb
        return (M, c)
    return lax.associative_scan(comb, (Ms, cs))


def _carry_in(ccum: jax.Array) -> jax.Array:
    """Exclusive-from-inclusive for a zero initial carry: the carry each
    step SEES is the previous step's cumulative value."""
    return jnp.concatenate([jnp.zeros_like(ccum[:1]), ccum[:-1]], axis=0)


def kkt_solve(f: StagewiseFactor, v: jax.Array,
              precision=lax.Precision.HIGHEST,
              pscan: bool = False) -> jax.Array:
    """``u = Qp^-1 v`` via the Riccati factor: minimize
    ``1/2 u'Qp u - v'u`` (dynamics from x0 = 0).  v, u: (H, nu, B).

    ``pscan=True`` replaces the two depth-H sequential scans with
    O(log H)-depth associative scans over the SAME affine recursions
    (backward: ``p_j = A_j'(I - W_j B_j') p_{j+1} + A_j' W_j v_j``;
    forward: ``x_{k+1} = (A_k - B_k K_k) x_k + B_k kff_k``) — identical
    math, float32 association order differs.  This is the hot-loop
    transform for long horizons: one PQP iteration calls this once, and
    at H = 512 the sequential version is 1024 latency-bound tiny-matmul
    steps.  Plant matrices are the per-stage stacks of the factor, so
    LTI and LTV take the same path.
    """
    if pscan:
        prec = precision
        eye = jnp.eye(f.ns, dtype=v.dtype)
        WBt = jnp.einsum("hij,hkj->hik", f.W, f.Bm, precision=prec)
        Mb = jnp.einsum("hji,hjk->hik", f.A, eye - WBt, precision=prec)
        Wv = jnp.einsum("hij,hjb->hib", f.W, v, precision=prec)
        cb = jnp.einsum("hji,hjb->hib", f.A, Wv, precision=prec)
        _, crev = _affine_cumulative(Mb[::-1], cb[::-1], prec)
        p_in = _carry_in(crev)[::-1]                 # p_{j+1} at stage j
        t = jnp.einsum("hji,hjb->hib", f.Bm, p_in, precision=prec) - v
        kff = -jnp.einsum("hij,hjb->hib", f.Hinv, t, precision=prec)
        Mf = f.A - jnp.einsum("hij,hjk->hik", f.Bm, f.K, precision=prec)
        cf = jnp.einsum("hij,hjb->hib", f.Bm, kff, precision=prec)
        _, cx = _affine_cumulative(Mf, cf, prec)
        x_in = _carry_in(cx)                         # x_k at stage k
        return -jnp.einsum("hij,hjb->hib", f.K, x_in,
                           precision=prec) + kff

    mm = lambda a, b: jnp.matmul(a, b, precision=precision)

    def back(p, inp):
        Ak, Bk, Hinv, W, vk = inp
        t = mm(Bk.T, p) - vk                     # (nu, B)
        kff = -mm(Hinv, t)
        p_new = mm(Ak.T, p - mm(W, t))
        return p_new, kff

    B_ = v.shape[-1]
    p0 = jnp.zeros((f.ns, B_), v.dtype)
    _, kff = lax.scan(back, p0, (f.A[::-1], f.Bm[::-1], f.Hinv[::-1],
                                 f.W[::-1], v[::-1]))
    kff = kff[::-1]                              # (H, nu, B)

    def fwd(x, inp):
        Ak, Bk, K, kf = inp
        u = -mm(K, x) + kf
        x_new = mm(Ak, x) + mm(Bk, u)
        return x_new, u

    x0 = jnp.zeros((f.ns, B_), v.dtype)
    _, u = lax.scan(fwd, x0, (f.A, f.Bm, f.K, kff))
    return u


def rollout_states(f: StagewiseFactor, x0: jax.Array, u: jax.Array,
                   dseq: Optional[jax.Array] = None,
                   precision=lax.Precision.HIGHEST,
                   pscan: bool = False) -> jax.Array:
    """States x_1..x_H from x0 under inputs u (H, nu, B): (H, ns, B)."""
    mm = lambda a, b: jnp.matmul(a, b, precision=precision)
    B_ = u.shape[-1]
    if dseq is None:
        dseq = jnp.zeros((f.H, f.E.shape[-1], B_), u.dtype)

    if pscan:
        cs = (jnp.einsum("hij,hjb->hib", f.Bm, u, precision=precision)
              + jnp.einsum("hij,hjb->hib", f.E, dseq,
                           precision=precision))
        Mcum, ccum = _affine_cumulative(f.A, cs, precision)
        return jnp.einsum("hij,jb->hib", Mcum, x0,
                          precision=precision) + ccum

    def step(x, inp):
        Ak, Bk, Ek, uk, dk = inp
        x_new = mm(Ak, x) + mm(Bk, uk) + mm(Ek, dk)
        return x_new, x_new

    _, xs = lax.scan(step, x0, (f.A, f.Bm, f.E, u, dseq))
    return xs


# ---------------------------------------------------------------------------
# Constraint operators: rows [up; lo; slew+; slew-], the exact layout of
# models/mpc.py input_constraints (N = 4*H*nu, reference PQP_CPU.c:941).

def _g_apply(U):
    """G U for U (H, nu, B) -> (4, H, nu, B)."""
    TU = U - jnp.concatenate([jnp.zeros_like(U[:1]), U[:-1]], axis=0)
    return jnp.stack([U, -U, TU, -TU], axis=0)


def _gt_apply(Y):
    """G' Y for Y (4, H, nu, B) -> (H, nu, B)."""
    up, lo, sp, sn = Y[0], Y[1], Y[2], Y[3]
    d = sp - sn
    Ttd = d - jnp.concatenate([d[1:], jnp.zeros_like(d[:1])], axis=0)
    return up - lo + Ttd


@_pytree_dataclass(meta_fields=("n_con", "band", "soft_rho",
                                "theta_floor"))
class StagewiseDual:
    """Matrix-free dual-geometry bundle: everything the PQP loop needs
    that depends only on (plant, costs, horizon).

    ``band_abs`` holds the **banded-exact hybrid split** (VERDICT r2
    task 3).  All 16 group-blocks of Qd are signed copies of four base
    blocks ``S = Qp^-1``, ``S T'``, ``T S``, ``T S T'`` (T = the slew
    first-difference), so the elementwise split ``Qd^± = (|Qd| ± Qd)/2``
    only needs ``|base|`` matvecs.  ``|base|`` entries within ``band``
    stages of the diagonal are stored EXACTLY (they fall out of the same
    build-time batched kkt_solve that computes the radii); the
    off-band tail — which decays like the closed-loop dynamics, since
    Qp^-1 is the input-block of a banded KKT inverse — keeps the rank-1
    Cauchy-Schwarz bound ``|Qd_ij| <= r_i r_j``.  At ``band = H-1`` the
    split is exact and the update's contraction matches the condensed
    path's reference split (updateY2, PQP_CPU.c:603-618) to float noise;
    the previous pure rank-1 split (band=0 minus even the diagonal) cost
    15.7x the condensed iterations at H=32 (CONTROLLER_BENCH_r2).

    ``band_abs[i, j, k, o]`` = the (nu, nu) block
    ``|base^{ij}|[stage k, stage k + o - band]`` for i, j in {box, slew};
    zero outside the horizon.

    Output (state) constraint rows ``y_min <= C x_k <= y_max`` extend
    the layout with two (H, ny) groups after the four input groups —
    beyond the reference's input-only constraint surface
    (PQP_CPU.c:941) and, since round 3, available matrix-free: the
    y-rows' ``G_y = C Su`` applies as the zero-state rollout and
    ``G_y'`` as its adjoint (one extra scan each), their bounds are
    per-instance (``Kp_y = y_max - C xbar``, from the same free
    response the forcing build computes), and the hybrid split gains
    banded ``|base|`` blocks for the in/out and out/out couplings
    (``band_io``/``band_oi``/``band_oo``; all six Qd super-blocks are
    still signed copies of bases built from {I, T, C Su}).  ``None``
    when the spec has no output bounds.

    Slack-softened output constraints (``spec.soft_penalty = rho``) add
    one slack per y-row (the condensed layout, models/mpc.py): variables
    ``(U, s+, s-)`` with primal Hessian ``blkdiag(Qp, 2 rho I, 2 rho I)``
    and rows ``[.., Gy U - s+ <= b+, -Gy U - s- <= b-, -s+ <= 0,
    -s- <= 0]``.  The slack-borne blocks of Qd are stage-local
    ``+1/(2 rho)`` identity couplings among {y+, s+} and {y-, s-} — all
    elementwise POSITIVE and handled EXACTLY by closed-form additions
    to the Qd/|Qd| applies (``_with_soft``); slack rows have zero
    coupling outside their stage-channel, so they contribute nothing to
    the rank-1 tail (radius 0).  The slacks themselves are recovered
    from the duals, ``s± = (Y_y± + Y_s±)/(2 rho) >= 0`` by
    construction.  ``soft_rho = 0`` means hard bounds.
    """

    factor: StagewiseFactor
    r_vec: jax.Array      # (4, H, nu)  Cauchy-Schwarz radii sqrt(Qd_ii)
    theta: jax.Array      # (4, H, nu)
    Kp: jax.Array         # (4, H, nu)
    band_abs: jax.Array   # (2, 2, H, 2*band+1, nu, nu)
    r_out: Optional[jax.Array] = None     # (H, ny) y-row radii
    theta_out: Optional[jax.Array] = None  # (2, H, ny)
    theta_soft: Optional[jax.Array] = None  # (2, H, ny)
    band_io: Optional[jax.Array] = None   # (2, H, 2b+1, nu, ny)
    band_oi: Optional[jax.Array] = None   # (2, H, 2b+1, ny, nu)
    band_oo: Optional[jax.Array] = None   # (H, 2b+1, ny, ny)
    y_max: Optional[jax.Array] = None     # (H, ny) +big where unbounded
    y_min: Optional[jax.Array] = None     # (H, ny)
    u_prev: Optional[jax.Array] = None    # (nu,) stage-0 slew anchor
    n_con: int = 0
    band: int = 0
    soft_rho: float = 0.0
    theta_floor: float = 5.0   # kept so relinearize can reuse it

    @property
    def has_y(self) -> bool:
        return self.r_out is not None

    @property
    def has_soft(self) -> bool:
        return self.soft_rho > 0.0


def _flat(Y):
    """(G, H, width, B) -> (G*H*width, B)."""
    s = Y.shape
    return Y.reshape(s[0] * s[1] * s[2], s[3])


def _unflat(Y, H, nu):
    return Y.reshape(4, H, nu, Y.shape[-1])


def _g_apply_all(dual: StagewiseDual, U: jax.Array,
                 precision=None, pscan: bool = False) -> jax.Array:
    """Full constraint apply ``G U`` -> flat (n_con, B): the four input
    groups (shifts/sign flips) plus, when present, the output groups
    ``+/- C x_k`` via the zero-state rollout."""
    rows = _flat(_g_apply(U))
    if not dual.has_y:
        return rows
    f = dual.factor
    xs = rollout_states(f, jnp.zeros((f.ns, U.shape[-1]), U.dtype), U,
                        None, precision, pscan)          # (H, ns, B)
    yv = jnp.einsum("hij,hjb->hib", f.C, xs, precision=precision)
    return jnp.concatenate([rows, _flat(jnp.stack([yv, -yv]))], axis=0)


def _gt_apply_all(dual: StagewiseDual, Yf: jax.Array,
                  precision=None, pscan: bool = False) -> jax.Array:
    """u-space adjoint ``G_u' Y`` for flat Y (n_con, B) -> (H, nu, B).
    Slack rows (soft outputs) have no u-columns and are ignored."""
    f = dual.factor
    H, nu = f.H, f.nu
    M4 = 4 * H * nu
    v = _gt_apply(_unflat(Yf[:M4], H, nu))
    if dual.has_y:
        Hny = H * f.ny
        Yo = Yf[M4:M4 + 2 * Hny].reshape(2, H, f.ny, Yf.shape[-1])
        v = v + _su_adjoint(f, Yo[0] - Yo[1], precision, pscan)
    return v


def _soft_parts(dual: StagewiseDual, Yf: jax.Array):
    """``(a, b) = ((Y_y+ + Y_s+)/(2 rho), (Y_y- + Y_s-)/(2 rho))`` —
    equal to the recovered slacks s± AND to the slack-borne rows of
    Qd·Y (the couplings are +1/(2 rho) among {y+, s+} / {y-, s-})."""
    f = dual.factor
    Hny = f.H * f.ny
    M4 = 4 * f.H * f.nu
    inv2rho = 1.0 / (2.0 * dual.soft_rho)
    y4 = Yf[M4:M4 + Hny]
    y5 = Yf[M4 + Hny:M4 + 2 * Hny]
    y6 = Yf[M4 + 2 * Hny:M4 + 3 * Hny]
    y7 = Yf[M4 + 3 * Hny:]
    return (y4 + y6) * inv2rho, (y5 + y7) * inv2rho


def _with_soft(dual: StagewiseDual, base: jax.Array, Yf: jax.Array):
    """Extend a Qd·Y (or |Qd|-bound) apply with the exact slack-borne
    terms: ``base`` covers the u-borne rows [input; y+; y-]; the slack
    couplings add ``a``/``b`` to the y rows and ARE the s rows."""
    if not dual.has_soft:
        return base
    f = dual.factor
    Hny = f.H * f.ny
    M4 = 4 * f.H * f.nu
    a, b = _soft_parts(dual, Yf)
    return jnp.concatenate([
        base[:M4],
        base[M4:M4 + Hny] + a,
        base[M4 + Hny:] + b,
        a, b], axis=0)


def _auto_band(absK: np.ndarray, rvec2: np.ndarray, H: int,
               widths: list, slack: float = 1.25) -> int:
    """Smallest band b (in stages) such that the hybrid bound's rowsums
    exceed the exact ``|Qd|`` rowsums by at most ``slack`` — i.e. the
    Cauchy-Schwarz inflation is confined to a tail that costs <= 25%
    extra theta (hence per-iteration contraction within ~25% of the
    exact split's).  ``absK``: the |base-block| super-matrix (one row
    block of width ``H*w`` per entry of ``widths``); ``rvec2``: radii
    in the same row order."""
    stage = np.concatenate([np.repeat(np.arange(H), w) for w in widths])
    dist = np.abs(stage[:, None] - stage[None, :])      # (2M, 2M)
    rr = rvec2[:, None] * rvec2[None, :]
    rs_exact = absK.sum(axis=1) + 1e-30
    for b in [0, 1, 2, 4, 8, 16, 32, 64, 128, 256]:
        if b >= H - 1:
            break
        inband = dist <= b
        rs_b = np.where(inband, absK, rr).sum(axis=1)
        if float((rs_b / rs_exact).max()) <= slack:
            return b
    return H - 1


def _extract_band(K: np.ndarray, H: int, ru: int, b: int,
                  rv: int | None = None) -> np.ndarray:
    """(H*ru, H*rv) dense base block -> (H, 2b+1, ru, rv) stage band,
    zero outside the horizon: ``out[k, o] = K[stage k, stage k+o-b]``."""
    rv = ru if rv is None else rv
    Kb = K.reshape(H, ru, H, rv).transpose(0, 2, 1, 3)   # (H, H, ru, rv)
    pad = np.zeros((H, b, ru, rv), K.dtype)
    Kp_ = np.concatenate([pad, Kb, pad], axis=1)         # (H, H+2b, ..)
    idx = np.arange(H)[:, None] + np.arange(2 * b + 1)[None, :]
    return Kp_[np.arange(H)[:, None], idx]               # (H, 2b+1, ..)


def _su_adjoint(f: StagewiseFactor, e: jax.Array,
                precision=lax.Precision.HIGHEST,
                pscan: bool = False,
                g_last: Optional[jax.Array] = None) -> jax.Array:
    """``Su' C' e`` for per-stage output seeds ``e (H, ny, B)`` — the
    adjoint of the zero-state rollout (slot j gets
    ``B_j' mu_j`` with ``mu_j = C_j' e_j + A_{j+1}' mu_{j+1}`` — the
    costate propagation into slot j rides the NEXT stage's dynamics,
    hence :func:`_a_shift`; for LTI this is the familiar
    ``B' sum_{k>=j} A'^{k-j} C' e_k``), as one backward scan or its
    associative-scan equivalent.  Shared by the forcing build (where e
    is the weighted tracking error) and the output-constraint rows'
    ``G_y'`` apply.

    ``g_last (ns, B)`` adds a STATE-space costate seed at the last
    stage (``mu_{H-1} += g_last``) — the terminal cost's gradient
    ``2 P x_H`` enters the adjoint there, alongside (not through) the
    output map."""
    Ash = _a_shift(f)
    if pscan:
        cs = jnp.einsum("hji,hjb->hib", f.C, e,
                        precision=precision)[::-1]
        if g_last is not None:
            cs = cs.at[0].add(g_last)      # reversed: slot 0 = stage H-1
        Ms = jnp.transpose(Ash[::-1], (0, 2, 1))
        _, mu = _affine_cumulative(Ms, cs, precision)
        return jnp.einsum("hji,hjb->hib", f.Bm[::-1], mu,
                          precision=precision)[::-1]

    mm = lambda a, b: jnp.matmul(a, b, precision=precision)

    def adj(mu, inp):
        Ashk, Ck, Bk, ek = inp
        mu_new = mm(Ck.T, ek) + mm(Ashk.T, mu)
        return mu_new, mm(Bk.T, mu_new)

    mu0 = jnp.zeros((f.ns, e.shape[-1]), jnp.float32)
    out_last = None
    if g_last is not None:
        # Ash[H-1] = 0 annihilates mu0, so the seed cannot ride the
        # carry; peel the last stage instead (one step, then the
        # un-seeded scan over the remaining H-1 stages).
        mu0 = mm(f.C[-1].T, e[-1]) + g_last
        out_last = mm(f.Bm[-1].T, mu0)
        if f.H == 1:
            return out_last[None]
        Ash, e = Ash[:-1], e[:-1]
        _, out_rev = lax.scan(adj, mu0,
                              (f.A[1:][::-1], f.C[:-1][::-1],
                               f.Bm[:-1][::-1], e[::-1]))
        return jnp.concatenate([out_rev[::-1], out_last[None]], axis=0)
    _, out_rev = lax.scan(adj, mu0,
                          (Ash[::-1], f.C[::-1], f.Bm[::-1], e[::-1]))
    return out_rev[::-1]                                 # (H, nu, B)


def _absqd_apply(dual: StagewiseDual, m: jax.Array, s: jax.Array,
                 w: Optional[jax.Array] = None, precision=None):
    """Hybrid ``|Qd|``-bound matvec: exact banded ``|base|`` blocks plus
    the rank-1 Cauchy-Schwarz tail off-band.  ``m = Y_up + Y_lo``,
    ``s = Y_s+ + Y_s-`` (each (H, nu, B)), ``w = Y_y+ + Y_y-``
    ((H, ny, B), output-constrained duals only) — all nonnegative.
    Returns ``(D_box, D_slew, D_y)`` — the bound applied rowwise per
    super-group (``D_y`` None without output rows).  Expanding to the
    signed groups is the caller's job (negated groups have identical
    row magnitudes)."""
    H, nu = dual.factor.H, dual.factor.nu
    b = dual.band
    wd = 2 * b + 1
    r_box, r_slew = dual.r_vec[0], dual.r_vec[2]          # (H, nu)
    r2 = jnp.stack([r_box, r_slew])                       # (2, H, nu)
    X2 = jnp.stack([m, s])                                # (2, H, nu, B)
    Xpad = jnp.pad(X2, ((0, 0), (b, b), (0, 0), (0, 0)))  # (2, H+2b, ..)
    idx = np.arange(H)[:, None] + np.arange(wd)[None, :]  # into padded
    Xwin = Xpad[:, idx]                                   # (2, H, wd, nu, B)
    bandY = jnp.einsum("ijhwuv,jhwvb->ihub", dual.band_abs, Xwin,
                       precision=precision)               # (2, H, nu, B)
    # rank-1 tail bookkeeping: per-stage weighted sums u_g[k] =
    # sum_v r_g[k,v] x_g[k,v]; the off-band total is the grand sum
    # minus each row's in-band window
    u = jnp.einsum("jhv,jhvb->jhb", r2, X2,
                   precision=precision)                   # (2, H, B)
    D_y = None
    if dual.has_y:
        ny = dual.r_out.shape[-1]
        Wpad = jnp.pad(w, ((b, b), (0, 0), (0, 0)))       # (H+2b, ny, B)
        Wwin = Wpad[idx]                                  # (H, wd, ny, B)
        bandY = bandY + jnp.einsum("ihwuv,hwvb->ihub", dual.band_io,
                                   Wwin, precision=precision)
        D_y = (jnp.einsum("jhwuv,jhwvb->hub", dual.band_oi, Xwin,
                          precision=precision)
               + jnp.einsum("hwuv,hwvb->hub", dual.band_oo, Wwin,
                            precision=precision))         # (H, ny, B)
        u_y = jnp.einsum("hv,hvb->hb", dual.r_out, w,
                         precision=precision)             # (H, B)
        u = jnp.concatenate([u, u_y[None]], axis=0)       # (3, H, B)
    upad = jnp.pad(u, ((0, 0), (b, b), (0, 0)))
    off = (jnp.sum(u, axis=(0, 1))[None]
           - jnp.sum(upad[:, idx], axis=(0, 2)))          # (H, B)
    off = off[:, None, :]                                 # (H, 1, B)
    if D_y is not None:
        D_y = D_y + dual.r_out[..., None] * off
    return (bandY[0] + r_box[..., None] * off,
            bandY[1] + r_slew[..., None] * off, D_y)


def _dual_blocks(f: StagewiseFactor, has_y: bool, pscan: bool) -> dict:
    """Radii and the dense ``|Qd|`` base blocks — pure jnp, traceable.

    One batched kkt_solve over all distinct constraint directions gives
    ``Z = Qp^-1 G'``; the radii are its diagonal inner products and the
    base blocks (``S = Qp^-1``, ``S T'``, ``T S T'``, plus the y-row
    couplings when present) are reshapes/differences of the same Z.
    """
    H, nu = f.H, f.nu
    M = H * nu
    # Distinct constraint directions: unit vectors e_{k,j} (box rows) and
    # differences e_{k,j} - e_{k-1,j} (slew rows; k=0 reduces to e_{0,j}).
    # One batched solve computes Qp^-1 g for all of them.
    eye = jnp.eye(M, dtype=jnp.float32).reshape(H, nu, M)
    # slew ROW k's direction is e_k - e_{k-1} = T' e_k (columnwise
    # up-shift difference), not T e_k
    diff = eye - jnp.concatenate(
        [eye[1:], jnp.zeros_like(eye[:1])], axis=0)  # (H, nu, M)
    G_all = jnp.concatenate([eye, diff], axis=-1)    # (H, nu, 2M)
    Z = kkt_solve(f, G_all, pscan=pscan)             # (H, nu, 2M)
    # r^2 = g' Qp^-1 g
    flat_g = G_all.reshape(M, 2 * M)
    flat_z = Z.reshape(M, 2 * M)
    r2 = jnp.sum(flat_g * flat_z, axis=0)            # (2M,)
    r_box = jnp.sqrt(jnp.maximum(r2[:M], 0.0)).reshape(H, nu)
    r_slew = jnp.sqrt(jnp.maximum(r2[M:], 0.0)).reshape(H, nu)

    # The base blocks of Qd, dense at BUILD time only (they are a
    # reshape of the same Z the radii needed): S = Qp^-1, ST' = Qp^-1 T',
    # TS = (ST')', TST' = T (ST').  Symmetrize S against scan-order
    # float asymmetry so |S| is exactly symmetric.
    S = flat_z[:, :M]
    S = 0.5 * (S + S.T)
    ST = flat_z[:, M:]
    STr = ST.reshape(H, nu, M)
    TST = (STr - jnp.concatenate([jnp.zeros_like(STr[:1]), STr[:-1]],
                                 axis=0)).reshape(M, M)
    TST = 0.5 * (TST + TST.T)
    blk = dict(r_box=r_box, r_slew=r_slew, S=S, ST=ST, TST=TST)

    if has_y:
        ny = f.ny
        # y-row directions g_{k,i} = Su'C'e_{k,i}: batched adjoint of
        # unit output seeds, then one batched kkt_solve — the same
        # O(H^2) pattern as the input radii.
        Hny = H * ny
        Eo = jnp.eye(Hny, dtype=jnp.float32).reshape(H, ny, Hny)
        Go = _su_adjoint(f, Eo, pscan=pscan)         # (H, nu, Hny)
        Zo = kkt_solve(f, Go, pscan=pscan)           # (H, nu, Hny)
        Zo_flat = Zo.reshape(M, Hny)                 # Qp^-1 Gy'
        # out x out base: Gy Qp^-1 Gy' = C * rollout(0, Zo) per stage
        xs = rollout_states(f, jnp.zeros((f.ns, Hny), jnp.float32), Zo,
                            pscan=pscan)
        OO = jnp.einsum("hij,hjb->hib", f.C, xs,
                        precision=lax.Precision.HIGHEST).reshape(Hny, Hny)
        OO = 0.5 * (OO + OO.T)
        r_out = jnp.sqrt(jnp.maximum(jnp.diag(OO), 0.0)).reshape(H, ny)
        Zr = Zo_flat.reshape(H, nu, Hny)
        TZo = (Zr - jnp.concatenate([jnp.zeros_like(Zr[:1]), Zr[:-1]],
                                    axis=0)).reshape(M, Hny)
        blk.update(Zo_flat=Zo_flat, TZo=TZo, OO=OO, r_out=r_out)
    return blk


def _extract_band_j(K: jax.Array, H: int, ru: int, b: int,
                    rv: int | None = None) -> jax.Array:
    """jnp twin of :func:`_extract_band` (``b`` static → traceable)."""
    rv = ru if rv is None else rv
    Kb = K.reshape(H, ru, H, rv).transpose(0, 2, 1, 3)   # (H, H, ru, rv)
    Kp_ = jnp.pad(Kb, ((0, 0), (b, b), (0, 0), (0, 0)))  # (H, H+2b, ..)
    idx = jnp.arange(H)[:, None] + jnp.arange(2 * b + 1)[None, :]
    return Kp_[jnp.arange(H)[:, None], idx]              # (H, 2b+1, ..)


def _dual_assemble(f: StagewiseFactor, blk: dict, band: int, has_y: bool,
                   soft_rho: float, y_min, y_max, umax, umin, dmax,
                   uprev, theta_floor: float, pscan: bool) -> StagewiseDual:
    """Band extraction + bounds + theta from the blocks — pure jnp with
    ``band``/``has_y``/``soft_rho`` static, so :func:`relinearize` can
    run the whole assembly under jit."""
    H, nu, ny = f.H, f.nu, f.ny
    M = H * nu
    r_box, r_slew = blk["r_box"], blk["r_slew"]
    r_vec = jnp.stack([r_box, r_box, r_slew, r_slew], axis=0)
    S, ST, TST = blk["S"], blk["ST"], blk["TST"]
    band_abs = jnp.stack([
        jnp.stack([_extract_band_j(jnp.abs(S), H, nu, band),
                   _extract_band_j(jnp.abs(ST), H, nu, band)]),
        jnp.stack([_extract_band_j(jnp.abs(ST.T), H, nu, band),
                   _extract_band_j(jnp.abs(TST), H, nu, band)])])
    # ^ (2, 2, H, 2b+1, nu, nu)

    r_out = theta_out = band_io = band_oi = band_oo = None
    if has_y:
        r_out = blk["r_out"]
        Zo_flat, TZo, OO = blk["Zo_flat"], blk["TZo"], blk["OO"]
        band_io = jnp.stack(
            [_extract_band_j(jnp.abs(Zo_flat), H, nu, band, ny),
             _extract_band_j(jnp.abs(TZo), H, nu, band, ny)])
        band_oi = jnp.stack(
            [_extract_band_j(jnp.abs(Zo_flat.T), H, ny, band, nu),
             _extract_band_j(jnp.abs(TZo.T), H, ny, band, nu)])
        band_oo = _extract_band_j(jnp.abs(OO), H, ny, band, ny)
        big = np.float32(1e6)   # one-sided bounds stay inert
        # normalized to per-stage (H, ny) schedules: a constant (ny,)
        # bound broadcasts; a (H, ny) stack (e.g. robust_spec's tube
        # tightening) passes through — the bound VALUES touch only the
        # per-instance Kp_y rows in _forcing, never the geometry
        y_max = (jnp.full((H, ny), big, jnp.float32) if y_max is None
                 else jnp.broadcast_to(
                     jnp.asarray(y_max, jnp.float32), (H, ny)))
        y_min = (jnp.full((H, ny), -big, jnp.float32) if y_min is None
                 else jnp.broadcast_to(
                     jnp.asarray(y_min, jnp.float32), (H, ny)))
    else:
        y_max = y_min = None

    umax = jnp.broadcast_to(jnp.asarray(umax, jnp.float32), (H, nu))
    umin = jnp.broadcast_to(jnp.asarray(umin, jnp.float32), (H, nu))
    dmax = jnp.broadcast_to(jnp.asarray(dmax, jnp.float32), (H, nu))
    uprev = jnp.zeros(nu, jnp.float32) if uprev is None else \
        jnp.asarray(uprev, jnp.float32)
    e1u = jnp.zeros((H, nu), jnp.float32).at[0].set(uprev)
    Kp = jnp.stack([umax, -umin, dmax + e1u, dmax - e1u], axis=0)

    n_con = 4 * M + (2 * H * ny if has_y else 0) \
        + (2 * H * ny if soft_rho else 0)
    sd = StagewiseDual(factor=f, r_vec=r_vec,
                       theta=jnp.zeros_like(r_vec), Kp=Kp,
                       band_abs=band_abs, r_out=r_out,
                       theta_out=theta_out, band_io=band_io,
                       band_oi=band_oi, band_oo=band_oo,
                       y_max=y_max, y_min=y_min, u_prev=uprev,
                       n_con=n_con, band=band, soft_rho=soft_rho,
                       theta_floor=theta_floor)

    # theta_i = max(rowsum(N)_i, floor) with N = (D - Qd)/2 the hybrid
    # split's negative part (D >= |Qd| >= Qd^- elementwise, so this
    # dominates the reference's rowsum(Qd^-) rule, PQP_CPU.c:503-519,
    # and converges to it as band -> H-1).  Qd1 and D1 both carry the
    # exact slack terms via _with_soft, so soft rows get theta from the
    # same rule.
    ones = jnp.ones((n_con, 1), jnp.float32)
    qd1 = _with_soft(sd, _g_apply_all(
        sd, kkt_solve(f, _gt_apply_all(sd, ones, pscan=pscan),
                      pscan=pscan), pscan=pscan), ones)[:, 0]
    two_u = 2.0 * jnp.ones((H, nu, 1), jnp.float32)
    two_y = 2.0 * jnp.ones((H, ny, 1), jnp.float32) if has_y else None
    D1_box, D1_slew, D1_y = _absqd_apply(sd, two_u, two_u, two_y)
    D1 = _flat(jnp.stack([D1_box, D1_box, D1_slew, D1_slew]))
    if has_y:
        D1 = jnp.concatenate([D1, _flat(jnp.stack([D1_y, D1_y]))])
    D1 = _with_soft(sd, D1, ones)[:, 0]
    th_all = jnp.maximum(0.5 * (D1 - qd1), theta_floor)
    theta = th_all[:4 * M].reshape(4, H, nu)
    theta_soft = None
    if has_y:
        theta_out = th_all[4 * M:4 * M + 2 * H * ny].reshape(2, H, ny)
    if soft_rho:
        theta_soft = th_all[4 * M + 2 * H * ny:].reshape(2, H, ny)
    return dataclasses.replace(sd, theta=theta, theta_out=theta_out,
                               theta_soft=theta_soft)


def stagewise_dual(spec: MPCSpec, theta_floor: float = 5.0,
                   pscan: Optional[bool] = None,
                   band: Optional[int] = None) -> StagewiseDual:
    """Build the matrix-free dual geometry: Riccati factor, the radii
    ``r_i = sqrt((G Qp^-1 G')_ii)`` (one batched kkt_solve over all
    distinct constraint vectors), the banded-exact ``|Qd|`` blocks for
    the hybrid split (see :class:`StagewiseDual`), and theta from the
    exact rowsum of the split's negative part.

    ``band`` — stage half-width of the exact band; ``None`` picks the
    smallest width whose Cauchy-Schwarz tail inflates the split's
    rowsums by <= 25% (``_auto_band``); ``H - 1`` makes the split exact.
    Build cost is O(H^2) either way (the radii already need all columns
    of Qp^-1 G'); solver memory stays O(H * band).

    Output bounds (``spec.y_min``/``y_max``) add two (H, ny) row groups
    (see the class docstring); constants ``(ny,)`` or per-stage
    ``(H, ny)`` schedules (robust tube tightening,
    :func:`~pqp_for_mpc_tpu.models.robust.robust_spec`) both work — the
    bound values only enter the per-instance Kp_y rows, never the
    geometry.  ``soft_penalty`` (slack-softened outputs) works too —
    the slack-borne Qd couplings are handled in closed form
    (``_with_soft``; see the class docstring and
    tests/test_stagewise.py::test_stagewise_soft_outputs_match_condensed).

    For receding-horizon loops that RELINEARIZE the plant every step
    (successive linearization / real-time iteration), build once here
    (auto band) and refresh with :func:`relinearize` — the refresh is
    pure jnp and runs under jit."""
    if getattr(spec, "moves", None) is not None:
        raise NotImplementedError(
            "move blocking is condensed-only (models/mpc.py): the "
            "stage-wise path is already O(H) per iteration")
    has_y = spec.y_min is not None or spec.y_max is not None
    soft_rho = float(spec.soft_penalty or 0.0) if has_y else 0.0
    f = riccati_factor(spec)
    H, nu, ny = f.H, f.nu, f.ny
    if pscan is None:
        # measured: the SEQUENTIAL scans win at build time (unlike the
        # solve) — the build batches O(H) columns through each scan, so
        # the matrix units are already fed and the associative form's
        # (H, ns, B) intermediates only add memory traffic (97 s vs
        # 213 s at H=512 on the CPU backend)
        pscan = False

    blk = _dual_blocks(f, has_y, pscan)
    if band is None:
        # band auto-selection inspects the dense blocks on the host —
        # the one build stage that cannot run under jit (the width is
        # structural); relinearize reuses the width chosen here
        S, ST, TST = (np.asarray(blk[k], np.float32)
                      for k in ("S", "ST", "TST"))
        rvec2 = np.concatenate(
            [np.asarray(blk["r_box"]).reshape(-1),
             np.asarray(blk["r_slew"]).reshape(-1)]
            + ([np.asarray(blk["r_out"]).reshape(-1)] if has_y else []))
        if has_y:
            Zo_flat, TZo, OO = (np.asarray(blk[k], np.float32)
                                for k in ("Zo_flat", "TZo", "OO"))
            absK = np.abs(np.block([[S, ST, Zo_flat],
                                    [ST.T, TST, TZo],
                                    [Zo_flat.T, TZo.T, OO]]))
            widths = [nu, nu, ny]
        else:
            absK = np.abs(np.block([[S, ST], [ST.T, TST]]))  # (2M, 2M)
            widths = [nu, nu]
        band = _auto_band(absK, rvec2, H, widths)
    band = int(min(max(band, 0), H - 1))
    return _dual_assemble(f, blk, band, has_y, soft_rho,
                          spec.y_min, spec.y_max, spec.u_max, spec.u_min,
                          spec.du_max, spec.u_prev, theta_floor, pscan)


def relinearize(sd: StagewiseDual, A: jax.Array, B: jax.Array,
                E: Optional[jax.Array] = None,
                C: Optional[jax.Array] = None,
                r: Optional[jax.Array] = None,
                u_prev: Optional[jax.Array] = None,
                pscan: bool = False) -> StagewiseDual:
    """Rebuild the dual geometry for NEW per-stage dynamics under the
    SAME static structure (horizon, band width, constraint groups) —
    pure jnp end to end, so it runs UNDER JIT.

    This is the hot path of nonlinear MPC by successive linearization
    (real-time iteration, examples/nonlinear_mpc.py): every control
    step produces fresh Jacobian stacks ``A, B (H, ns, ·)`` along the
    shifted nominal trajectory, and the Riccati factorization, split
    radii, banded ``|Qd|`` blocks and theta must follow.  An eager
    ``stagewise_dual`` build pays ~0.5 s of Python dispatch per step;
    ``relinearize`` inside a jitted step is part of one compiled graph
    (see :class:`~pqp_for_mpc_tpu.models.rti.RTIController`).

    ``E``/``C``/``r`` default to the previous factor's; ``u_prev``
    moves the stage-0 slew bounds.  Cost weights, input bounds, output
    bounds, theta floor and the band width are inherited from ``sd``
    (the auto-selected band stays valid while the linearization
    geometry drifts slowly — the receding-horizon regime; rebuild with
    :func:`stagewise_dual` on a regime change)."""
    f0 = sd.factor
    A = jnp.asarray(A, jnp.float32)
    B = jnp.asarray(B, jnp.float32)
    E = f0.E if E is None else jnp.asarray(E, jnp.float32)
    C = f0.C if C is None else jnp.asarray(C, jnp.float32)
    r = f0.r if r is None else jnp.asarray(r, jnp.float32)
    if r.ndim == 1:
        r = jnp.broadcast_to(r, (f0.H, f0.ny))
    f = _riccati_core(A, B, E, C, f0.Qy, f0.R, r, f0.P)
    blk = _dual_blocks(f, sd.has_y, pscan)
    # recover the bound vectors from the stacked Kp rows:
    # Kp = [umax, -umin, dmax + e1 uprev, dmax - e1 uprev].  umax/umin
    # survive +-inf entries (disabled bounds); dmax does too (inf+inf).
    # u_prev comes from the stored field, NOT from 0.5*(Kp[2,0]-Kp[3,0])
    # — that difference is inf - inf = NaN when du_max is +inf.
    umax, umin = sd.Kp[0], -sd.Kp[1]
    dmax = 0.5 * (sd.Kp[2] + sd.Kp[3])
    uprev = sd.u_prev if u_prev is None else jnp.asarray(u_prev,
                                                         jnp.float32)
    return _dual_assemble(f, blk, sd.band, sd.has_y, sd.soft_rho,
                          sd.y_min, sd.y_max, umax, umin, dmax, uprev,
                          sd.theta_floor, pscan)


def _forcing(dual: StagewiseDual, x0, dseq, prec, pscan: bool = False):
    """Per-instance forcing: Fp (H, nu, B), Mp (B,), Fd, Md, QiF, and
    the per-instance flat constraint bounds kp_full (n_con, B).

    Fp_k = B' mu_{k+1} with the adjoint recursion
    mu_j = C'Qy(C xbar_j - r) + A' mu_{j+1} over the free response
    xbar (inputs = 0); Mp = sum_j |C xbar_j - r|^2_Qy; then
    Fd = Kp + G Qp^-1 Fp and Md = Fp'Qp^-1 Fp - Mp exactly as
    computeFd/computeMd (PQP_CPU.c:456-479).  Output-constraint rows'
    bounds ride the free response already computed here:
    Kp_y = [y_max - C xbar; C xbar - y_min]."""
    f = dual.factor
    mm = lambda a, b: jnp.matmul(a, b, precision=prec)
    B_ = x0.shape[-1]
    zeros_u = jnp.zeros((f.H, f.nu, B_), jnp.float32)
    xbar = rollout_states(f, x0, zeros_u, dseq, prec, pscan)  # (H, ns, B)
    # outputs per stage: (H, ny, B)
    ybar = jnp.einsum("hij,hjb->hib", f.C, xbar, precision=prec)
    e = ybar - f.r[:, :, None]
    # doubled weights: Fp = 2 Su'Qbar err, Mp = 2 sum |err|^2 (the
    # reference's 1/2 U'QpU + Fp'U + 1/2 Mp convention, see
    # riccati_factor); the terminal cost adds 2 xbar_H'P xbar_H to Mp
    # and seeds the adjoint with its state-space gradient 2 P xbar_H
    Qe = 2.0 * jnp.einsum("hij,hjb->hib", f.Qy, e, precision=prec)
    Mp = jnp.sum(e * Qe, axis=(0, 1))                      # (B,)
    Pxh = 2.0 * mm(f.P, xbar[-1])                          # (ns, B)
    Mp = Mp + jnp.sum(xbar[-1] * Pxh, axis=0)

    Fp = _su_adjoint(f, Qe, prec, pscan, g_last=Pxh)       # (H, nu, B)

    QiF = kkt_solve(f, Fp, prec, pscan)
    Md = jnp.sum(Fp * QiF, axis=(0, 1)) - Mp               # (B,)
    kp_full = jnp.broadcast_to(_flat(dual.Kp[..., None]),
                               (4 * f.H * f.nu, B_))
    if dual.has_y:
        kp_y = jnp.stack([dual.y_max[:, :, None] - ybar,
                          ybar - dual.y_min[:, :, None]])
        kp_full = jnp.concatenate([kp_full, _flat(kp_y)], axis=0)
    GQiF = _g_apply_all(dual, QiF, prec, pscan)
    if dual.has_soft:
        # slack rows: bounds 0 and no u/forcing coupling (G row [0, -I],
        # Qp_full^-1 Fp_full's slack part is 0)
        zs = jnp.zeros((2 * f.H * f.ny, B_), jnp.float32)
        kp_full = jnp.concatenate([kp_full, zs], axis=0)
        GQiF = jnp.concatenate([GQiF, zs], axis=0)
    Fd = kp_full + GQiF                                    # (N, B)
    return Fp, Mp, Fd, Md, QiF, kp_full


@partial(jax.jit, static_argnames=("cfg", "pscan", "retry_cold"))
def solve_stagewise(dual: StagewiseDual, x0: jax.Array,
                    dseq: Optional[jax.Array] = None,
                    Y0: Optional[jax.Array] = None,
                    cfg: SolverConfig = SolverConfig(),
                    pscan: Optional[bool] = None,
                    retry_cold: bool = False) -> SolveResult:
    """Run the PQP dual iteration matrix-free over a batch of initial
    states.  ``x0``: (ns,) or (ns, B); ``dseq``: optional (H, nd, B).
    Returns a :class:`SolveResult` with ``U (H*nu, B)``, ``Y (N, B)``.

    Semantics mirror :func:`pqp_for_mpc_tpu.solver.solve_batched` (same
    four-part terminate, masked lanes, divergence freeze); only the
    linear algebra is implicit.

    ``pscan`` selects the temporal-parallel (associative-scan) KKT
    recursions; ``None`` = auto (on for H >= 64, where the depth-H
    sequential scans dominate the iteration latency; the crossover is
    not yet measured on the GPU, ROADMAP D4).
    """
    f = dual.factor
    H, nu = f.H, f.nu
    if pscan is None:
        pscan = H >= 64
    prec = lax.Precision.HIGHEST if cfg.precision == "highest" else None
    x0 = x0 if x0.ndim == 2 else x0[:, None]
    B = x0.shape[1]
    N = dual.n_con

    Fp, Mp, Fd, Md, QiF, kp_full = _forcing(dual, x0, dseq, prec, pscan)
    Fdp = jnp.maximum(Fd, 0.0)
    Fdn = jnp.maximum(-Fd, 0.0)
    M4 = 4 * H * nu
    th_col = _flat(dual.theta[..., None])
    if dual.has_y:
        th_col = jnp.concatenate([th_col,
                                  _flat(dual.theta_out[..., None])])
    if dual.has_soft:
        th_col = jnp.concatenate([th_col,
                                  _flat(dual.theta_soft[..., None])])
    kp_slack = kp_full + jnp.maximum(cfg.erc * kp_full, cfg.eac)

    def kkt_gty(Yf):
        """Z = Qp^-1 G' Y, the shared inner solve: (N, B) -> (H, nu, B)."""
        return kkt_solve(f, _gt_apply_all(dual, Yf, prec, pscan),
                         prec, pscan)

    def qd_apply(Yf):
        """Qd Y, flat (N, B) -> (N, B) — u-borne part through the KKT
        solve, slack-borne part closed-form (_with_soft)."""
        return _with_soft(dual,
                          _g_apply_all(dual, kkt_gty(Yf), prec, pscan),
                          Yf)

    def update(Yf):
        """Multiplicative update under the banded-exact hybrid split
        (see :class:`StagewiseDual`): with D >= |Qd| the elementwise
        bound, P Y = (D Y + Qd Y)/2 + theta Y and N Y = (D Y - Qd Y)/2
        + theta Y; the negated row-groups need no extra work because
        |Qd| rows repeat: D Y depends on Y only through m = Y_up + Y_lo,
        s = Y_s+ + Y_s- (and w = Y_y+ + Y_y- with output rows)."""
        qdY = qd_apply(Yf)
        Y4 = _unflat(Yf[:M4], H, nu)
        Yw = None
        if dual.has_y:
            Yo = Yf[M4:M4 + 2 * H * f.ny].reshape(2, H, f.ny, -1)
            Yw = Yo[0] + Yo[1]
        D_box, D_slew, D_y = _absqd_apply(dual, Y4[0] + Y4[1],
                                          Y4[2] + Y4[3], Yw, prec)
        DY = _flat(jnp.stack([D_box, D_box, D_slew, D_slew]))
        if dual.has_y:
            DY = jnp.concatenate([DY, _flat(jnp.stack([D_y, D_y]))])
        # slack-borne |Qd| entries are positive, so the exact additions
        # serve both the Qd apply and the |Qd| bound
        DY = _with_soft(dual, DY, Yf)
        # num is >= 0 in exact arithmetic (D >= |Qd| entrywise); the
        # banded part is a float DIFFERENCE of two programs, so clamp
        # the eps-level negatives that would flip Y's sign
        num = jnp.maximum(0.5 * (DY - qdY) + th_col * Yf + Fdn, 0.0)
        den = 0.5 * (DY + qdY) + th_col * Yf + Fdp
        if cfg.den_eps:
            den = jnp.maximum(den, cfg.den_eps)
        return (num / den) * Yf

    def accel(Yf, Yprev, tm, done):
        """Momentum-extrapolated projected-gradient accel with exact
        line search and gradient-based adaptive restart (O'Donoghue &
        Candes 2015): the plain per-step projected-gradient accel of
        round 2 converged, but on the flat long-horizon dual
        (kappa(Qd) ~ 1e7 at H=512) its steepest-descent rate left the
        H=512 solve 13k iterations/step (CONTROLLER_BENCH_r2); the
        FISTA-style extrapolation recovers the accelerated rate
        (measured: viol 1.9e-6 at 512 iters vs 7.4e-5 unaccelerated on
        the H=512 double integrator).  Restart zeroes the momentum when
        the prox-gradient mapping opposes the last step, which also
        safeguards against the non-monotone excursions interacting
        badly with the interleaved multiplicative updates."""
        tn = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * tm * tm))
        beta = ((tm - 1.0) / tn)[None, :]
        Z = jnp.maximum(Yf + beta * (Yf - Yprev), 0.0)
        grad = qd_apply(Z) + Fd
        p = jnp.where((Z > 0.0) | (grad < 0.0), -grad, 0.0)
        pQp = jnp.sum(p * qd_apply(p), axis=0)
        alpha = jnp.where(pQp > 0,
                          jnp.sum(p * p, axis=0)
                          / jnp.maximum(pQp, 1e-30), 0.0)
        Yn = jnp.maximum(Z + alpha[None, :] * p, 0.0)
        restart = jnp.sum((Z - Yn) * (Yn - Yf), axis=0) > 0.0
        Yn = jnp.where(done[None, :], Yf, Yn)
        return (Yn, jnp.where(done[None, :], Yprev, Yf),
                jnp.where(done, tm, jnp.where(restart, 1.0, tn)))

    def check(Yf):
        # Recovery U = -(QiF + Z) with Z = Qp^-1 G'Y.  CRITICAL: the
        # two terms are solved SEPARATELY and share QiF with the Fd
        # build (_forcing).  Fusing them into one ``kkt_solve(Fp +
        # G'Y)`` (round 2's form) puts the O(|Fp|)-scale forcing
        # through the scans on every check, and its f32 noise (~5e-3 in
        # constraint units at H=512, measured) lands directly in the
        # feasibility residual.  With the split form the residual
        # telescopes:  G U - Kp = -(Fd + Qd Y) + eps  — exactly the
        # negative dual gradient under the solver's own operator — so
        # the recovery noise CANCELS between Fd and U and the certified
        # violation tracks the dual residual (~1e-5), not the forcing
        # magnitude.  The reference has the same consistency by
        # construction (single Qp^-1 products reused, PQP_CPU.c:352-360,
        # 632-641).  One shared inner solve Z serves both the recovery
        # and Qd·Y = G(Z)+soft.
        Z = kkt_gty(Yf)
        U = -(QiF + Z)
        qdY_shared = _with_soft(dual, _g_apply_all(dual, Z, prec, pscan),
                                Yf)
        GU = _g_apply_all(dual, U, prec, pscan)
        s_pen = 0.0
        if dual.has_soft:
            # slacks recovered from the duals (class docstring);
            # consistent-operator style: the same quantities enter the
            # Qd apply, so feasibility telescopes like the u-rows'
            sa, sb = _soft_parts(dual, Yf)
            Hny = H * f.ny
            GU = jnp.concatenate([
                GU[:M4],
                GU[M4:M4 + Hny] - sa, GU[M4 + Hny:] - sb,
                -sa, -sb], axis=0)
            s_pen = dual.soft_rho * (jnp.sum(sa * sa, axis=0)
                                     + jnp.sum(sb * sb, axis=0))
        feas = jnp.all(GU <= kp_slack, axis=0)
        qdY = qdY_shared
        Jd = (0.5 * jnp.sum(Yf * qdY, axis=0)
              + jnp.sum(Fd * Yf, axis=0) + 0.5 * Md)
        # Jp via the definition 1/2 U'QpU + Fp'U + 1/2 Mp, with QpU
        # evaluated from the identity QpU = -(Fp + G'Y*)... NOT valid off
        # the solution; use the stage-cost rollout instead (numerically
        # identical, O(H)):
        xs = rollout_states(f, jnp.zeros_like(x0), U, None, prec,
                            pscan)
        # 1/2 U'Qp U with Qp = 2*(Su'Qbar Su + Rbar) equals the
        # UNSCALED stage quadratic of the zero-x0 rollout
        ysU = jnp.einsum("hij,hjb->hib", f.C, xs, precision=prec)
        quad = jnp.sum(
            ysU * jnp.einsum("hij,hjb->hib", f.Qy, ysU, precision=prec),
            axis=(0, 1))
        Ru = jnp.einsum("hij,hjb->hib", f.R, U, precision=prec)
        quad = quad + jnp.sum(U * Ru, axis=(0, 1))
        # terminal state weight: 1/2 U'QpU carries x_H(U)'P x_H(U)
        quad = quad + jnp.sum(
            xs[-1] * jnp.matmul(f.P, xs[-1], precision=prec), axis=0)
        Jp = quad + s_pen + jnp.sum(Fp * U, axis=(0, 1)) + 0.5 * Mp
        if cfg.gap_from_complementarity:
            # Jp(U(Y)) + Jd(Y) = Y'(Qd Y + Fd) exactly (the Mp/Md
            # constants cancel; SolverConfig.gap_from_complementarity).
            # The matrix-free path gains even more than the condensed
            # one: its explicit Jp additionally carries the stage-cost
            # rollout's accumulation noise.
            gap = jnp.sum(Yf * (qdY + Fd), axis=0)
            weak = gap > 0.0
        else:
            gap = Jp + Jd
            weak = Jp > -Jd
        fail = (~feas | (gap > cfg.eaj)
                | (gap / jnp.abs(Jd) > cfg.erj))
        if cfg.strict_weak_duality:
            fail = fail | weak
        return ~fail, U, feas, Jp, Jd

    warm = Y0 is not None
    if Y0 is None:
        Y0 = jnp.full((N, B), cfg.y0, jnp.float32)
    else:
        # mirror solve_batched's warm-start semantics: a single warm
        # start seeds the whole batch; a mismatched batch is an error
        # (silently recycling lane 0 would be a quiet wrong answer)
        if Y0.shape[1] == 1 and B > 1:
            Y0 = jnp.broadcast_to(Y0, (N, B))
        elif Y0.shape[1] != B:
            raise ValueError(
                f"warm start batch {Y0.shape[1]} != instance batch {B}")
    k = cfg.check_every

    def run_updates(Y, Yprev, tm, done):
        if not cfg.accel_every:
            def body(_, Yc):
                return jnp.where(done[None, :], Yc, update(Yc))
            return lax.fori_loop(0, k, body, Y), Yprev, tm

        def chunk(_, carry):
            Yc, Yp, tc = carry
            def body(_, Yc2):
                return jnp.where(done[None, :], Yc2, update(Yc2))
            Yc = lax.fori_loop(0, cfg.accel_every, body, Yc)
            return accel(Yc, Yp, tc, done)
        return lax.fori_loop(0, k // cfg.accel_every, chunk,
                             (Y, Yprev, tm))

    def cond(state):
        Y, Yprev, tm, done, h, iters, div = state
        return jnp.logical_and(~jnp.all(done), h <= cfg.max_iters)

    def body(state):
        Y, Yprev, tm, done, h, iters, div = state
        ok, _, _, _, _ = check(Y)
        bad = ~jnp.all(jnp.isfinite(Y), axis=0) & ~done
        newly = ok & ~done & ~bad
        iters = jnp.where(newly | bad, h, iters)
        done = done | ok | bad
        div = div | bad
        Y, Yprev, tm = run_updates(Y, Yprev, tm, done)
        return (Y, Yprev, tm, done, h + jnp.int32(k), iters, div)

    def solve_once(Y0f):
        done0 = jnp.zeros((B,), bool)
        it0 = jnp.zeros((B,), jnp.int32)
        div0 = jnp.zeros((B,), bool)
        Y, _, _, done, h, iters, div = lax.while_loop(
            cond, body, (Y0f, Y0f, jnp.ones((B,), jnp.float32), done0,
                         jnp.int32(1), it0, div0))

        ok, U, feas, Jp, Jd = check(Y)
        bad = ~jnp.all(jnp.isfinite(Y), axis=0)
        newly_bad = bad & ~done
        div = div | newly_bad
        newly = ok & ~done & ~bad
        iters = jnp.where(newly | newly_bad, h, iters)
        done = done | ok | bad
        iters = jnp.where(done, iters, h)
        return SolveResult(U=U.reshape(H * nu, B), Y=Y, iters=iters,
                           converged=done & ~div, feasible=feas,
                           Jp=Jp, Jd=Jd, diverged=div)

    if retry_cold and warm:
        from pqp_for_mpc_tpu.solver import retry_cold_solve
        Y_cold = jnp.full((N, B), cfg.y0, jnp.float32)
        return retry_cold_solve(solve_once, Y0, Y_cold)
    return solve_once(Y0)
