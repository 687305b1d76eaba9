"""Solver configuration.

The reference hard-codes every knob as a compile-time ``#define``
(tolerances ``PQP_CPU.c:19-22``, iteration cap ``PQP_CPU.c:24``, theta floor
inside ``diagonalAdd`` ``PQP_CPU.c:235-242``, Y0 inside ``solveQuadraticDual``
``PQP_CPU.c:710``).  Here they are runtime values carried in a small static
dataclass; array shapes stay static so everything jits once per shape.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static configuration for the PQP dual solver.

    Attributes mirror the reference's compile-time constants:

    * ``erc, eac, eaj, erj`` — the four convergence tolerances
      (relative/absolute constraint, absolute/relative duality gap),
      ref ``PQP_CPU.c:19-22`` (all ``1e-6``).
    * ``theta_floor`` — floor applied to the diagonal regularizer
      theta_ii = max(rowsum(Qd^-)_i, theta_floor), ref ``PQP_CPU.c:240``
      (``5.0``; the benchmark-harness variants use ``100.0``).
    * ``y0`` — initial dual iterate value, ref ``PQP_CPU.c:710`` (``1000.0``).
    * ``max_iters`` — hard iteration cap.  The reference's root variants
      iterate unboundedly until convergence (``PQP_CPU.c:718``); a cap is the
      principled equivalent (static upper bound for the while loop when
      needed, and divergence protection the reference lacks).
    * ``check_every`` — convergence-check cadence.  The reference checks
      every iteration (11 matmuls per check, ``PQP_CPU.c:673-687``).  The
      multiplicative update itself never reads the check's outputs, so
      checking every k-th iteration leaves the iterate trajectory unchanged
      and only coarsens the *reported* iteration count to a multiple of k.
    * ``unroll`` — how many multiplicative updates to fuse per while-loop
      body between checks (``check_every`` must be a multiple).
    * ``precision`` — 'highest' for float32 matrix products (parity
      with the C oracle); 'default' lets the GPU take float32 products
      in TF32 (about 10 mantissa bits) — faster, not a parity mode.
    """

    erc: float = 1e-6
    eac: float = 1e-6
    eaj: float = 1e-6
    erj: float = 1e-6
    theta_floor: float = 5.0
    y0: float = 1000.0
    max_iters: int = 200_000
    check_every: int = 1
    # Acceleration cadence: every ``accel_every`` multiplicative updates,
    # take one projected steepest-descent step with exact line search
    # (direction p_i = -grad_i masked to the feasible cone, step
    # alpha = |p|^2 / p'Qd p, then Y <- max(0, Y + alpha p)), accepted
    # per-instance only when it does not increase the dual objective.
    # This is the *correct* form of the reference's acceleration branch
    # (computeph/computealphaY/updateY1, PQP_CPU.c:545-630 — dead code in
    # the root variants and defective where live: its direction
    # ``-2 Qd Y`` drops the Fd term, PQP_CPU.c:621-626, and the step is
    # damped by 10 with no projection, PQP_GPU_optimized_coarsened.cu:825).
    # 0 disables (reference-parity default).  Cuts the slow multiplicative
    # tail by orders of magnitude on active-set-heavy QPs and lets
    # multipliers leave the absorbing state Y_i = 0.
    accel_every: int = 0
    precision: str = "highest"
    # The reference's first gap test (``Jp > -Jd`` fails, PQP_CPU.c:682)
    # demands a numerically NON-POSITIVE duality gap; in exact arithmetic
    # the gap is >= 0, so passing relies on float32 rounding landing at or
    # below zero.  On some instances it settles one ulp above and the
    # reference would iterate forever.  True (default) keeps the
    # reference's semantics for conformance; False drops that test and
    # terminates on the two-sided gap tolerances alone (recommended for
    # production).
    strict_weak_duality: bool = True
    # Certify the duality gap via the complementarity identity instead of
    # the reference's explicit cost difference.  For the recovered primal
    # U = -Qp^-1(Fp + Gp'Y) the gap collapses algebraically:
    #
    #   Jp(U) + Jd(Y) = Y'(Qd Y + Fd)
    #
    # (substitute U into Jp: the Fp'Qp^-1 Fp and Mp terms cancel against
    # Md's definition, PQP_CPU.c:456-479).  The two sides are equal in
    # exact arithmetic but wildly different in float32: Jp and Jd each
    # carry the constants Mp/2 and Md/2 — Md itself a catastrophic
    # difference Fp'Qp^-1 Fp - Mp of quantities that can dwarf the
    # optimal cost — so the explicit gap's noise floor is
    # ~eps * max(|Mp|, |Fp'Qp^-1 Fp|), while the complementarity form
    # never touches those constants and floors at ~eps * |Jd| (measured
    # on the H=512 double integrator: explicit-gap noise ~1e-3 against
    # |Jd| ~ 45 vs complementarity ~1e-5 — two orders tighter
    # certification).  Off by default for reference conformance (the
    # golden 313-iteration parity pins the reference's exact float
    # program, computeCost PQP_CPU.c:648-666); MPC_CONFIG and
    # stagewise_mpc_config enable it.  The whole-solve GPU kernel
    # honors it too.
    gap_from_complementarity: bool = False
    # Evaluate the feasibility residual through the operator-consistent
    # identity Gp U - Kp = -(Qd Y + Fd) (exact for the recovered U)
    # instead of re-deriving Gp @ U at forcing scale — the condensed
    # analog of the stage-wise split recovery (round 3), see
    # solver.check_terminate.  Cancels the f32 forcing-scale recovery
    # noise that floors the certifiable feasibility slack (measured on
    # the H=32 double-integrator loop: the externally-audited f64
    # violation of a "feasible" verdict drops ~an order of magnitude).
    # Off by default: the reference's checkFeas program is Gp U
    # (PQP_CPU.c:632-641) and golden conformance keeps it; MPC_CONFIG
    # enables it.  XLA paths only — the whole-solve GPU kernel keeps the
    # reference's program and does not take this flag.
    feas_from_dual_gradient: bool = False
    # Guard the reference's unguarded divide (``updY``, PQP_CPU.c:594).
    # Denominator (Qd^+ + theta) Y + Fd^+ is strictly positive for Y > 0 in
    # exact arithmetic (theta_ii >= 5 > 0), but float32 underflow can drive
    # it to exactly 0 when Y does (e.g. a warm start with tiny multipliers
    # and Fd^+_i = 0), and then 0/0 -> NaN poisons the whole iterate.  The
    # default clamp is far below any representable well-posed denominator,
    # so it changes no trajectory; it only turns 0/0 into 0 (and Y_i = 0
    # stays 0 either way since the update multiplies by Y_i).
    den_eps: float = 1e-30

    def __post_init__(self):
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")
        if self.accel_every < 0:
            raise ValueError("accel_every must be >= 0")
        if self.accel_every > 0 and self.check_every % self.accel_every:
            raise ValueError(
                "check_every must be a multiple of accel_every so each "
                "while-loop body runs a whole number of accel chunks")
        if self.precision not in ("highest", "default"):
            raise ValueError("precision must be 'highest' or 'default'")


#: Recommended configuration for receding-horizon MPC (float32):
#:
#: * tolerances loosened to what float32 can actually certify at O(1)
#:   constraint scales — the reference's 1e-6 absolute feasibility slack
#:   is unreachable when Kp ~ 1 (its example has Kp = 20 and costs ~1e5,
#:   so 1e-6 *relative* scales land above float32 resolution there);
#: * ``strict_weak_duality=False`` — the reference's ``Jp > -Jd`` test
#:   demands the numerical gap land at or below zero; on many MPC QPs it
#:   settles a few ulps above (observed: +1.4e-5 on a gap of rel. 4e-7)
#:   and the loop never exits;
#: * small cold start + acceleration (see SolverConfig docstrings).
MPC_CONFIG = SolverConfig(
    erc=1e-4, eac=1e-4, eaj=1e-4, erj=1e-4,
    y0=0.01, check_every=8, accel_every=4,
    strict_weak_duality=False, max_iters=50_000,
    gap_from_complementarity=True,
    # round 5: the operator-consistent feasibility certificate (see the
    # field docstring) — measured on the bench double integrator:
    # condensed H=128 goes from 30% certified at 14k iters/step to 100%
    # at 41 iters/step at these very tolerances, and still certifies
    # 97% at erc=1e-5 (previously the condensed rows needed slack
    # ~4e-5*H, benchmarks/bench_controller.py)
    feas_from_dual_gradient=True,
)

def stagewise_mpc_config(horizon: int) -> SolverConfig:
    """MPC_CONFIG with tolerances lifted to the float32 certification
    floor of the stage-wise (matrix-free) path at the given horizon.

    Round 2 needed slack ~4e-5*H (1e-2 at H=512) because the primal
    recovery re-solved ``kkt(Fp + G'Y)`` — the O(|Fp|)-scale forcing
    went through the f32 Riccati scans at every check and its noise
    (~5e-3 at H=512) landed in the feasibility residual, while the
    loose rank-1 dual split needed >20k iterations to approach the
    optimum at all.  Round 3 removed both binders (banded-exact split +
    momentum accel + the operator-consistent split recovery
    ``U = -(QiF + kkt(G'Y))``, see stagewise.py): the H=512 double
    integrator now certifies erc=1e-4 cold in ~200 iterations with the
    EXTERNALLY-evaluated violation tracking the certificate (2.2e-5
    measured).  The remaining floor is the f32 noise of the small-
    magnitude dual-gradient evaluation, ~1e-5/stage-coupling — the
    slack model below keeps an order of margin for saturated
    closed-loop steps (slew bounds driven negative, ROADMAP #10)."""
    if horizon <= 32:
        return MPC_CONFIG
    slack = min(2e-6 * horizon, 1e-3)
    # Gap tolerances: with gap_from_complementarity (on in MPC_CONFIG)
    # the relative-gap noise floor is ~1e-5 regardless of horizon (it
    # never touches the Mp/Md constants); erj=1e-3 keeps two orders of
    # margin and eaj=1e-3 is 10x round 2's.
    return dataclasses.replace(
        MPC_CONFIG, erc=slack, eac=slack, erj=1e-3, eaj=1e-3,
        max_iters=20_000)


#: Tolerances used by the reference's ``testing/`` benchmark harnesses
#: (``testing/CPU version/PQP_CPU_test.c:19-24``): inert values so that the
#: fixed-iteration loop isolates per-iteration kernel cost.  It is a
#: throughput harness only: ``precision="default"`` (TF32 on the GPU)
#: is never a parity setting.
BENCH_CONFIG = SolverConfig(
    erc=7.0, eac=1e5, eaj=1e5, erj=7.0, theta_floor=100.0, max_iters=100,
    precision="default",
)
