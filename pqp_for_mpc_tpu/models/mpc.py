"""Condensed-MPC problem construction and the receding-horizon loop.

The reference *loads* the condensed blocks (Qp_inv, Fp1..3, Mp1..6, Gp, Kp)
from text files and never derives them (``input()``, PQP_CPU.c:757-930).
This module closes that gap: given any :class:`LinearPlant`, a horizon and
cost/constraint specs, :func:`condense` produces a
:class:`CondensedMPCData` with exactly the reference's block semantics —
i.e. ``assemble(x, D)`` then reproduces

    Fp = Fp1 D + Fp2 x - Fp3                          (PQP_CPU.c:373-382)
    Mp = 1/2 (x'Mp1 x + D'Mp2 x + Mp4.x
              + D'Mp3 D + Mp5.D + Mp6)                (PQP_CPU.c:395-428)

for the tracking cost
    J(U) = sum_k (y_k - r)' Qy (y_k - r) + u_k' R u_k
over the stacked prediction
    X = Sx x0 + Su U + Sd Dseq,   y_k = C x_k,
with box input bounds and slew-rate bounds contributing the reference's
characteristic ``N = 4 * horizon * n_input`` constraint rows
(PQP_CPU.c:941: N = 4*pHorizon*nInput).

Problem build runs on the HOST in float64 (NumPy; build-time, off the
hot path — see :func:`condense`), then casts the finished blocks to float32 for the
device.  The traceable jnp build (:func:`prediction_matrices`) remains
for in-graph uses; horizon is static either way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np

from pqp_for_mpc_tpu.models.plants import LinearPlant
from pqp_for_mpc_tpu.problem import CondensedMPCData
from pqp_for_mpc_tpu.config import SolverConfig
from pqp_for_mpc_tpu.dual import dual_geometry, dualize, dualize_forcing
from pqp_for_mpc_tpu.solver import SolveResult, solve_batched
from pqp_for_mpc_tpu.routing import solve_auto


@dataclasses.dataclass(frozen=True)
class MPCSpec:
    """Cost and constraint specification for condensation.

    ``plant`` may be an LTI :class:`LinearPlant` or a time-varying
    :class:`~pqp_for_mpc_tpu.models.plants.LTVPlant` (stacked per-stage
    matrices, e.g. from successive linearization of a nonlinear plant —
    examples/nonlinear_mpc.py); ``r`` may be a constant ``(ny,)``
    reference or a per-stage ``(H, ny)`` trajectory.  ``Qy``/``R`` may
    likewise be constant or per-stage stacks ``(H, ny, ny)``/``(H, nu,
    nu)`` (time-varying weights: ramp-up schedules, terminal output
    emphasis, trust-region R in SQP loops).  ``P`` adds the textbook
    terminal state cost ``x_H' P x_H`` (e.g. the DARE solution, the
    standard closed-loop stability certificate for finite-horizon MPC
    — a surface the reference's fixed-file pipeline cannot express).
    Both backends (condensed and stage-wise) accept every form.
    """

    plant: LinearPlant
    horizon: int
    Qy: np.ndarray            # (ny, ny) or (H, ny, ny) tracking weight
    R: np.ndarray             # (nu, nu) or (H, nu, nu) input weight
    r: np.ndarray             # (ny,) or (H, ny) output reference
    u_min: np.ndarray         # (nu,) or per-stage (H, nu)
    u_max: np.ndarray         # (nu,) or per-stage (H, nu)
    du_max: np.ndarray        # (nu,) or (H, nu) slew-rate bound
    u_prev: Optional[np.ndarray] = None  # previous input for rate rows
    # Optional output (state) constraints y_min <= y_k <= y_max over the
    # horizon — beyond the reference's input-only constraint surface.
    # Their condensed bounds depend on (x, D): Kp = Kp0 + Kx x + Kd D.
    y_min: Optional[np.ndarray] = None   # (ny,)
    y_max: Optional[np.ndarray] = None   # (ny,)
    # Soften the output constraints with nonnegative slacks s and a
    # quadratic penalty rho*|s|^2: hard output constraints can make the
    # QP infeasible for reachable states; softened ones always admit a
    # solution.  None = hard constraints.
    soft_penalty: Optional[float] = None
    # Terminal state cost x_H' P x_H (P PSD, (ns, ns)); None = no
    # terminal term.  Enters Qp/Fp/Mp on the condensed path and the
    # Riccati init on the stage-wise path.
    P: Optional[np.ndarray] = None
    # Move blocking (condensed backend): hold the input constant over
    # blocks of stages, so the decision variable shrinks from H*nu to
    # n_moves*nu and the dual from 4*H*nu to 4*n_moves*nu rows — the
    # classic way to make long-horizon condensed MPC cheap (the dual
    # Hessian shrinks QUADRATICALLY in the blocking factor).  Either an
    # int (H split as evenly as possible) or an explicit tuple of
    # per-move stage counts summing to H (e.g. (1, 1, 2, 4, 8, 16) —
    # fine near now, coarse far out).  The COST still charges every
    # stage; box bounds aggregate to the tightest in each block and
    # slew rows live at block boundaries, so the blocked solution is
    # feasible for the original per-stage constraints by construction.
    # None = no blocking.  The stage-wise backend rejects it (it is
    # already O(H) and blocking would break its Riccati structure).
    moves: Optional[object] = None


def prediction_matrices(plant: LinearPlant, H: int):
    """Stacked prediction:  X = Sx x0 + Su U + Sd Dseq  for x_1..x_H.

    Sx: (H*ns, ns); Su: (H*ns, H*nu) block lower-triangular with blocks
    ``Phi(i, j+1) B_j`` (``Phi(a, b) = A_{a-1} ... A_b``, = A^{i-j-1} B
    for LTI); Sd likewise with E.  Built by accumulating transition
    products — O(H^2) small matmuls at trace time.  Accepts an LTI
    :class:`~pqp_for_mpc_tpu.models.plants.LinearPlant` (2-D matrices)
    or an :class:`~pqp_for_mpc_tpu.models.plants.LTVPlant` (stacked
    3-D), the latter produced e.g. by successive linearization of a
    nonlinear plant (examples/nonlinear_mpc.py).

    Both forms build through ONE ``lax.scan`` over stages (O(H) traced
    ops, O(H^2) FLOPs — the latter is inherent: Su has H^2/2 nonzero
    blocks).  Row i carries the previous row's blocks forward through
    one batched ``A_i @ .`` and inserts ``B_i``/``E_i`` on the
    diagonal, so tracing stays flat in H (a Python-level block loop
    emitted ~130k ops at H=512 and made condensed LTV builds
    impractical at long horizons; the scan compiles in seconds there).
    The stage-wise backend (models/stagewise.py) remains the
    production path at flagship horizons — it never materializes Su
    at all — and is the only path that relinearizes under jit
    (models/rti.py).
    """
    ltv = np.asarray(plant.A).ndim == 3
    ns, nu = plant.n_state, plant.n_input
    nd = plant.n_dist

    A = jnp.asarray(plant.A)
    B = jnp.asarray(plant.B)
    E = jnp.asarray(plant.E)
    if ltv and A.shape[0] != H:
        raise ValueError(f"LTV plant horizon {A.shape[0]} != {H}")
    dt = A.dtype
    if not ltv:     # LTI = constant stacks through the same scan
        A = jnp.broadcast_to(A, (H, ns, ns))
        B = jnp.broadcast_to(B, (H, ns, nu))
        E = jnp.broadcast_to(E, (H, ns, nd))

    def step(carry, inp):
        # carry holds row i-1's blocks: sx = Phi(i, 0),
        # su[j] = Phi(i, j+1) B_j (zero for j >= i), sd likewise
        sx, su, sd = carry
        Ai, Bi, Ei, i = inp
        sx = Ai @ sx
        su = jnp.einsum("pk,jkq->jpq", Ai, su)
        sd = jnp.einsum("pk,jkq->jpq", Ai, sd)
        su = lax.dynamic_update_index_in_dim(su, Bi, i, 0)
        sd = lax.dynamic_update_index_in_dim(sd, Ei, i, 0)
        return (sx, su, sd), (sx, su, sd)

    init = (jnp.eye(ns, dtype=dt),
            jnp.zeros((H, ns, nu), dt),
            jnp.zeros((H, ns, nd), dt))
    _, (Sx_s, Su_s, Sd_s) = lax.scan(step, init,
                                     (A, B, E, jnp.arange(H)))
    Sx = Sx_s.reshape(H * ns, ns)
    # stacked (i, j, ns, *) -> block matrix (i, ns, j, *)
    Su = Su_s.transpose(0, 2, 1, 3).reshape(H * ns, H * nu)
    Sd = Sd_s.transpose(0, 2, 1, 3).reshape(H * ns, H * nd)
    return Sx, Su, Sd


def _bound_flat(v, H: int, nu: int, xp):
    """Flat (H*nu,) bound vector from a constant ``(nu,)`` bound or a
    per-stage ``(H, nu)`` schedule (time-varying bounds: actuator
    derating, terminal input boxes, move-blocking-style patterns)."""
    dt = np.float64 if xp is np else None
    a = xp.asarray(v, dt) if dt else xp.asarray(v, xp.float32)
    if a.ndim == 2:
        if a.shape != (H, nu):
            raise ValueError(f"per-stage bound shape {a.shape} != "
                             f"({H}, {nu})")
        return a.reshape(-1)
    return xp.tile(a, H)


def input_constraints(spec: MPCSpec):
    """Box + slew-rate rows:  Gp U <= Kp,  N = 4*H*nu rows.

    Layout: [U <= umax; -U <= -umin; T U <= dumax + e1 uprev;
    -T U <= dumax - e1 uprev] with T the first-difference operator
    (u_0 - u_prev, u_1 - u_0, ...).
    """
    H, nu = spec.horizon, spec.plant.n_input
    M = H * nu
    I = jnp.eye(M, dtype=jnp.float32)
    # first-difference operator over the input sequence
    T = jnp.eye(M, dtype=jnp.float32) - jnp.eye(M, k=-nu, dtype=jnp.float32)
    Gp = jnp.concatenate([I, -I, T, -T], axis=0)                 # (4M, M)

    umax = _bound_flat(spec.u_max, H, nu, jnp)
    umin = _bound_flat(spec.u_min, H, nu, jnp)
    dmax = _bound_flat(spec.du_max, H, nu, jnp)
    uprev = jnp.zeros(nu, jnp.float32) if spec.u_prev is None else \
        jnp.asarray(spec.u_prev, jnp.float32)
    e1u = jnp.concatenate([uprev, jnp.zeros(M - nu, jnp.float32)])
    Kp = jnp.concatenate([umax, -umin, dmax + e1u, dmax - e1u])  # (4M,)
    return Gp, Kp


def _prediction_matrices_f64(plant: LinearPlant, H: int):
    """Host-side float64 prediction build for :func:`_condense` — same
    recurrence as :func:`prediction_matrices` but in NumPy: the build
    runs once per (plant, horizon) and its accuracy bounds everything
    downstream (kappa(Qp) grows ~H^4; an f32 build alone injects noise
    above the solver's certification tolerances at long horizons), and
    it runs once per build, off the hot path, so the split is f64 on
    the host, f32 blocks on the device."""
    ltv = np.asarray(plant.A).ndim == 3
    ns, nu, nd = plant.n_state, plant.n_input, plant.n_dist
    A = np.asarray(plant.A, np.float64)
    B = np.asarray(plant.B, np.float64)
    E = np.asarray(plant.E, np.float64)
    if ltv:
        if A.shape[0] != H:
            raise ValueError(f"LTV plant horizon {A.shape[0]} != {H}")
    else:
        A = np.broadcast_to(A, (H, ns, ns))
        B = np.broadcast_to(B, (H, ns, nu))
        E = np.broadcast_to(E, (H, ns, nd))
    Sx = np.zeros((H * ns, ns))
    Su = np.zeros((H * ns, H * nu))
    Sd = np.zeros((H * ns, H * nd))
    sx = np.eye(ns)
    su = np.zeros((H, ns, nu))
    sd = np.zeros((H, ns, nd))
    for i in range(H):
        sx = A[i] @ sx
        su = np.einsum("pk,jkq->jpq", A[i], su)
        sd = np.einsum("pk,jkq->jpq", A[i], sd)
        su[i] = B[i]
        sd[i] = E[i]
        Sx[i * ns:(i + 1) * ns] = sx
        Su[i * ns:(i + 1) * ns] = su.transpose(1, 0, 2).reshape(ns, H * nu)
        Sd[i * ns:(i + 1) * ns] = sd.transpose(1, 0, 2).reshape(ns, H * nd)
    return Sx, Su, Sd


def dare_terminal_weight(plant: LinearPlant, Qy, R,
                         max_iters: int = 10_000,
                         tol: float = 1e-12) -> np.ndarray:
    """Infinite-horizon cost-to-go ``P`` for the UNSCALED tracking cost
    ``sum |C x|^2_Qy + |u|^2_R`` — the textbook ``MPCSpec.P`` choice
    (terminal cost = what an infinite horizon would charge, turning a
    short-horizon MPC into the constrained LQR near the origin).

    Solved by value iteration on the discrete algebraic Riccati
    equation in float64 on the host (build-time, never hot).  LTI
    plants only — an LTV/linearization user should evaluate at the
    operating point.
    """
    A = np.asarray(plant.A, np.float64)
    B = np.asarray(plant.B, np.float64)
    C = np.asarray(plant.C, np.float64)
    if A.ndim != 2:
        raise ValueError("dare_terminal_weight needs an LTI plant")
    Q = C.T @ np.asarray(Qy, np.float64) @ C
    R = np.asarray(R, np.float64)
    P = Q.copy()
    for _ in range(max_iters):
        BtP = B.T @ P
        P_next = Q + A.T @ P @ A - A.T @ P @ B @ np.linalg.solve(
            R + BtP @ B, BtP @ A)
        P_next = 0.5 * (P_next + P_next.T)
        if np.abs(P_next - P).max() <= tol * max(1.0, np.abs(P).max()):
            return P_next.astype(np.float32)
        P = P_next
    raise ValueError("DARE value iteration did not converge "
                     "(unstabilizable plant or undetectable cost?)")


def _stage_weight_diag(W, H: int, n: int, name: str) -> np.ndarray:
    """Block-diagonal stacked weight: a constant ``(n, n)`` weight
    krons across stages; a per-stage ``(H, n, n)`` stack fills the
    blocks individually (time-varying weights)."""
    W = np.asarray(W, np.float64)
    if W.ndim == 2:
        if W.shape != (n, n):
            raise ValueError(f"{name} shape {W.shape} != ({n}, {n})")
        return np.kron(np.eye(H), W)
    if W.shape != (H, n, n):
        raise ValueError(f"{name} shape {W.shape} != ({H}, {n}, {n})")
    out = np.zeros((H * n, H * n))
    for k in range(H):
        out[k * n:(k + 1) * n, k * n:(k + 1) * n] = W[k]
    return out


def move_schedule(moves, H: int) -> np.ndarray:
    """Resolve ``MPCSpec.moves`` to an array of per-move stage counts.
    An int n splits H as evenly as possible into n blocks (earlier
    blocks get the remainder stage each — finer resolution near now);
    a tuple is validated to positive ints summing to H."""
    if isinstance(moves, (int, np.integer)):
        n = int(moves)
        if not 1 <= n <= H:
            raise ValueError(f"moves={n} not in [1, {H}]")
        base, rem = divmod(H, n)
        return np.array([base + (1 if j < rem else 0) for j in range(n)])
    lengths = np.asarray(moves, dtype=int)
    if lengths.ndim != 1 or (lengths < 1).any() or lengths.sum() != H:
        raise ValueError(f"move schedule {moves!r} must be positive "
                         f"stage counts summing to horizon {H}")
    return lengths


def _blocking_matrix(lengths: np.ndarray, nu: int) -> np.ndarray:
    """U = Mb V: ``Mb (H*nu, n_moves*nu)`` repeats move j's value over
    its ``lengths[j]`` stages."""
    H = int(lengths.sum())
    n = len(lengths)
    S = np.zeros((H, n))
    k = 0
    for j, L in enumerate(lengths):
        S[k:k + L, j] = 1.0
        k += L
    return np.kron(S, np.eye(nu))


def _blocked_input_constraints_f64(spec: MPCSpec, lengths: np.ndarray):
    """Input rows on the blocked variable V: box bounds take the
    TIGHTEST per-stage bound inside each block, slew rows sit at block
    boundaries (within-block first differences are identically zero),
    so ``U = Mb V`` satisfies every original per-stage row."""
    H, nu = spec.horizon, spec.plant.n_input
    n = len(lengths)
    Mv = n * nu
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    umax = _bound_flat(spec.u_max, H, nu, np).reshape(H, nu)
    umin = _bound_flat(spec.u_min, H, nu, np).reshape(H, nu)
    dmax = _bound_flat(spec.du_max, H, nu, np).reshape(H, nu)
    umax_v = np.stack([umax[s:s + L].min(axis=0)
                       for s, L in zip(starts, lengths)]).reshape(-1)
    umin_v = np.stack([umin[s:s + L].max(axis=0)
                       for s, L in zip(starts, lengths)]).reshape(-1)
    dmax_v = dmax[starts].reshape(-1)          # boundary-stage slew bound
    I = np.eye(Mv)
    T = np.eye(Mv) - np.eye(Mv, k=-nu)
    Gp = np.concatenate([I, -I, T, -T], axis=0)                  # (4Mv, Mv)
    uprev = np.zeros(nu) if spec.u_prev is None else \
        np.asarray(spec.u_prev, np.float64)
    e1u = np.concatenate([uprev, np.zeros(Mv - nu)])
    Kp = np.concatenate([umax_v, -umin_v, dmax_v + e1u, dmax_v - e1u])
    return Gp, Kp


def _input_constraints_f64(spec: MPCSpec):
    """Float64 twin of :func:`input_constraints` for the host build."""
    H, nu = spec.horizon, spec.plant.n_input
    M = H * nu
    I = np.eye(M)
    T = np.eye(M) - np.eye(M, k=-nu)
    Gp = np.concatenate([I, -I, T, -T], axis=0)                  # (4M, M)
    umax = _bound_flat(spec.u_max, H, nu, np)
    umin = _bound_flat(spec.u_min, H, nu, np)
    dmax = _bound_flat(spec.du_max, H, nu, np)
    uprev = np.zeros(nu) if spec.u_prev is None else \
        np.asarray(spec.u_prev, np.float64)
    e1u = np.concatenate([uprev, np.zeros(M - nu)])
    Kp = np.concatenate([umax, -umin, dmax + e1u, dmax - e1u])   # (4M,)
    return Gp, Kp


def condense(spec: MPCSpec) -> CondensedMPCData:
    """Derive the condensed blocks in the reference's exact block
    conventions (so :meth:`CondensedMPCData.assemble` reproduces the
    tracking cost; see module docstring for the algebra).

    Problem build runs ONCE per (plant, horizon) on the HOST in
    float64, and the finished blocks are cast to float32 for the
    device solve.  Build accuracy bounds solver accuracy: kappa(Qp)
    reaches ~1e11 for stiff plants at modest horizons, where an f32
    build's noise (ordering-dependent, ~kappa*eps_f32) already exceeds
    the certification tolerances — while the f64 build leaves the f32
    CAST as the only error, which is the floor anything f32-on-device
    can achieve.  The step is build-time and off the hot path (it is
    O(H^2 ns^2) once), so host NumPy is its home.
    """
    return _condense(spec)


def _condense(spec: MPCSpec) -> CondensedMPCData:
    plant, H = spec.plant, spec.horizon
    ns, nu, nd, ny = (plant.n_state, plant.n_input, plant.n_dist,
                      plant.n_output)
    M = H * nu

    Sx, Su, Sd = _prediction_matrices_f64(plant, H)
    C = np.asarray(plant.C, np.float64)
    if C.ndim == 3:      # LTV: per-stage output maps, block-diagonal
        Cs = np.zeros((H * ny, H * ns))
        for k in range(H):
            Cs[k * ny:(k + 1) * ny, k * ns:(k + 1) * ns] = C[k]
    else:
        Cs = np.kron(np.eye(H), C)
    Qbar = _stage_weight_diag(spec.Qy, H, ny, "Qy")
    Rbar = _stage_weight_diag(spec.R, H, nu, "R")
    r = np.asarray(spec.r, np.float64)
    if r.ndim == 2:      # per-stage reference (H, ny)
        if r.shape != (H, ny):
            raise ValueError(f"reference shape {r.shape} != ({H}, {ny})")
        rbar = r.reshape(-1)
    else:
        rbar = np.tile(r, H)                                     # (H*ny,)

    if spec.P is not None:
        # Terminal cost x_H' P x_H as ns extra zero-reference "outputs"
        # selecting the last state block: append Sel_H = [0 .. 0 I] to
        # Cs and blkdiag P into Qbar — every cost block below then
        # carries the terminal term through unchanged algebra.  The
        # OUTPUT-CONSTRAINT geometry must not see these rows; it slices
        # the leading H*ny rows back out (``rows_u`` below).
        P = np.asarray(spec.P, np.float64)
        if P.shape != (ns, ns):
            raise ValueError(f"terminal P shape {P.shape} != ({ns},{ns})")
        sel = np.zeros((ns, H * ns))
        sel[:, (H - 1) * ns:] = np.eye(ns)
        Cs = np.concatenate([Cs, sel], axis=0)
        Qbar = np.block([
            [Qbar, np.zeros((H * ny, ns))],
            [np.zeros((ns, H * ny)), P]])
        rbar = np.concatenate([rbar, np.zeros(ns)])

    CSu = Cs @ Su        # (Hny[+ns], M)
    CSx = Cs @ Sx        # (Hny[+ns], ns)
    CSd = Cs @ Sd        # (Hny[+ns], Hnd)

    Mv = M
    if spec.moves is not None:
        # Move blocking: substitute U = Mb V everywhere.  The cost
        # still charges every stage (CSu absorbs Mb; Rbar contracts to
        # Mb' Rbar Mb), so this is the textbook blocked problem, not a
        # coarser-grid approximation.
        lengths = move_schedule(spec.moves, H)
        Mb = _blocking_matrix(lengths, nu)
        CSu = CSu @ Mb
        Rbar = Mb.T @ Rbar @ Mb
        Mv = len(lengths) * nu
    QCSu = Qbar @ CSu

    # J = (CSu U + c)'Qbar(CSu U + c) + U'Rbar U,
    # c = CSx x + CSd D - rbar  ==  1/2 U'Qp U + Fp'U + 1/2 Mp with:
    Qp = 2.0 * (CSu.T @ QCSu + Rbar)
    Fp1 = 2.0 * QCSu.T @ CSd                                     # (M, Hnd)
    Fp2 = 2.0 * QCSu.T @ CSx                                     # (M, ns)
    Fp3 = 2.0 * QCSu.T @ rbar                                    # (M,)
    # Mp blocks match computeMp's actual arithmetic (all five assembled
    # terms carry the +1/2 factor; PQP_CPU.c:403-425):
    Mp1 = 4.0 * CSx.T @ Qbar @ CSx                               # (ns, ns)
    Mp2 = 8.0 * CSd.T @ Qbar @ CSx                               # (Hnd, ns)
    Mp3 = 4.0 * CSd.T @ Qbar @ CSd                               # (Hnd, Hnd)
    Mp4 = -8.0 * CSx.T @ (Qbar @ rbar)                           # (ns,)
    Mp5 = -8.0 * CSd.T @ (Qbar @ rbar)                           # (Hnd,)
    Mp6 = 4.0 * rbar @ (Qbar @ rbar)                             # ()

    if spec.moves is None:
        Gp, Kp = _input_constraints_f64(spec)
    else:
        Gp, Kp = _blocked_input_constraints_f64(spec, lengths)
    Kx = Kd = None
    if spec.y_min is not None or spec.y_max is not None:
        # Output constraints: y = CSu U + CSx x + CSd D, so
        #   CSu U <= ymax - CSx x - CSd D     (rows with Kx = -CSx)
        #  -CSu U <= -ymin + CSx x + CSd D    (rows with Kx = +CSx)
        # Constraint bounds become state-dependent: Kp(x, D) =
        # Kp0 + Kx x + Kd D, handled by CondensedMPCData.assemble.
        big = 1e6  # one-sided bounds stay inert

        def _ybound(v, default):
            # constant (ny,) or per-stage (H, ny) schedule (e.g. tube
            # tightening, models/robust.py), flattened stage-major
            if v is None:
                return np.full(H * ny, default)
            a = np.asarray(v, np.float64)
            if a.ndim == 2:
                if a.shape != (H, ny):
                    raise ValueError(f"per-stage output bound shape "
                                     f"{a.shape} != ({H}, {ny})")
                return a.reshape(-1)
            return np.tile(a, H)

        ymax = _ybound(spec.y_max, big)
        ymin = _ybound(spec.y_min, -big)
        rows_u = CSu[:H * ny]      # output rows only (skip terminal-P)
        n_out = 2 * H * ny
        Gp = np.concatenate([Gp, rows_u, -rows_u], axis=0)
        Kp = np.concatenate([Kp, ymax, -ymin])
        Zx = np.zeros((4 * Mv, ns))
        Zd = np.zeros((4 * Mv, H * nd))
        Kx = np.concatenate([Zx, -CSx[:H * ny], CSx[:H * ny]], axis=0)
        Kd = np.concatenate([Zd, -CSd[:H * ny], CSd[:H * ny]], axis=0)

        if spec.soft_penalty is not None:
            # Slack softening: V = [U; s], s >= 0 penalized rho|s|^2.
            # Output rows become  +/-CSu U - s <= bound  and n_out extra
            # rows enforce s >= 0 (with zero state dependence).
            rho = float(spec.soft_penalty)
            Qp = np.block([
                [Qp, np.zeros((Mv, n_out))],
                [np.zeros((n_out, Mv)), 2.0 * rho * np.eye(n_out)]])
            zrow = lambda A: np.concatenate(
                [A, np.zeros((n_out, A.shape[1]))], axis=0)
            Fp1, Fp2 = zrow(Fp1), zrow(Fp2)
            Fp3 = np.concatenate([Fp3, np.zeros(n_out)])
            slack_cols = np.concatenate([
                np.zeros((4 * Mv, n_out)), -np.eye(n_out)], axis=0)
            Gp = np.concatenate([
                np.concatenate([Gp, slack_cols], axis=1),
                np.concatenate([np.zeros((n_out, Mv)), -np.eye(n_out)],
                               axis=1)], axis=0)
            Kp = np.concatenate([Kp, np.zeros(n_out)])
            Kx = np.concatenate([Kx, np.zeros((n_out, ns))], axis=0)
            Kd = np.concatenate([Kd, np.zeros((n_out, H * nd))], axis=0)

    Qp_inv = np.linalg.inv(Qp)

    f32 = lambda a: (None if a is None
                     else jnp.asarray(np.asarray(a), jnp.float32))
    return CondensedMPCData(
        Qp_inv=f32(Qp_inv), Qp=f32(Qp),
        Fp1=f32(Fp1), Fp2=f32(Fp2), Fp3=f32(Fp3),
        Mp1=f32(Mp1), Mp2=f32(Mp2), Mp3=f32(Mp3), Mp4=f32(Mp4),
        Mp5=f32(Mp5), Mp6=f32(Mp6),
        Gp=f32(Gp), Kp=f32(Kp),
        # Z is file-format parity only (unused by the solve); an LTV
        # plant has no single output map - record stage 0's.
        Z=f32(C[0] if C.ndim == 3 else C),
        ThetaOut=jnp.zeros((ny, nd), jnp.float32),
        x=jnp.zeros(ns, jnp.float32), D=jnp.zeros(H * nd, jnp.float32),
        Kx=f32(Kx), Kd=f32(Kd))


# ---------------------------------------------------------------------------
# Receding-horizon closed loop
# ---------------------------------------------------------------------------

from pqp_for_mpc_tpu.solver import merge_lanes as _merge_lanes  # noqa: F401
# (kept under the old private name: the cold-retry merge now lives in
# solver.retry_cold_solve, shared by solve_batched and solve_stagewise)


#: auto_backend's condensed->stage-wise crossover, as the CONDENSED dual
#: dimension n_con.  Between 1024 and 2048 the dense path's O(n_con^2)
#: Qd stream and its iteration count (370 iters/step at H=256 vs the
#: matrix-free path's 22, double integrator) overtake the stage-wise
#: path's per-iteration scans.  Not yet measured on the GPU (ROADMAP D4).
_AUTO_BACKEND_NCON = 1536


def condensed_n_con(spec: MPCSpec) -> int:
    """Constraint count of the condensed dual for ``spec`` (the N whose
    square the dense path materializes): 4 input-row groups (box+slew,
    the reference's layout, PQP_CPU.c:941) over the move-blocked stage
    count, plus 2 output groups when bounds are present, plus 2
    slack-positivity groups when softened."""
    H, nu, ny = spec.horizon, spec.plant.n_input, spec.plant.n_output
    Hv = len(move_schedule(spec.moves, H)) if spec.moves is not None else H
    n = 4 * Hv * nu
    if spec.y_min is not None or spec.y_max is not None:
        n += 2 * H * ny
        if spec.soft_penalty is not None:
            n += 2 * H * ny
    return n


def auto_backend(spec: MPCSpec) -> str:
    """Pick the MPC backend for ``spec``: ``"condensed"`` (dense dual,
    the reference's formulation) while its n_con stays below the
    measured crossover, ``"stagewise"`` (matrix-free O(H)) beyond it.
    Move blocking (the one condensed-only feature) forces
    ``"condensed"`` at any horizon."""
    if spec.moves is not None:
        return "condensed"
    return ("condensed" if condensed_n_con(spec) < _AUTO_BACKEND_NCON
            else "stagewise")


class MPCController:
    """Receding-horizon controller around the batched PQP solver.

    Warm starting carries the dual iterate Y* between consecutive solves —
    the domain analog of checkpoint/resume (SURVEY.md §5): consecutive QPs
    differ only in (x, u_prev), so the previous multipliers are a near-
    optimal initialization and cut iterations by ~an order of magnitude.
    """

    def __init__(self, spec: MPCSpec, cfg: Optional[SolverConfig] = None,
                 warm_start=True,
                 cold_start_y0: Optional[float] = None,
                 warm_start_floor: float = 1e-6,
                 backend: str = "condensed",
                 retry_cold: bool = False):
        # warm_start: False | True (carry multipliers) | "shift" (carry
        # AND advance them one control stage — see _shift_multipliers)
        # retry_cold: certify-or-recover.  A warm start whose active set
        # is badly wrong can stall the multiplicative update past
        # max_iters (observed at H=512: a stalled step's carried
        # multipliers poison the NEXT warm start and the whole rest of
        # the rollout runs uncertified, while a cold solve certifies in
        # ~1000 iters).  With retry_cold, any step that fails the
        # four-part certification is re-solved once from the cold start
        # (lax.cond in the jitted rollout: the retry costs compile time
        # always, runtime only when taken), and the retry's multipliers
        # replace the poisoned carry.  Failure RECOVERY on top of the
        # failure detection the reference lacks (SURVEY.md §5).
        # backend: "condensed" (dense Qd, the reference's formulation) or
        # "stagewise" (matrix-free O(H) path, models/stagewise.py — for
        # long horizons where the dense (4*H*nu)^2 dual is prohibitive;
        # full constraint surface: input box + slew + output bounds,
        # hard or slack-softened).  The stage-wise default
        # cfg lifts tolerances to the horizon's float32 certification
        # floor (stagewise_mpc_config); pass an explicit cfg to
        # override.
        from pqp_for_mpc_tpu.config import MPC_CONFIG, stagewise_mpc_config
        if backend == "auto":
            backend = auto_backend(spec)
        if backend not in ("condensed", "stagewise"):
            raise ValueError(f"unknown backend {backend!r}")
        # Move blocking shrinks the input-row groups from H to n_moves
        # "stages"; _Hv is the effective count every per-step Kp update
        # and multiplier shift below must use.
        self._n_moves = None
        if spec.moves is not None:
            if backend == "stagewise":
                raise NotImplementedError(
                    "move blocking is a condensed-backend device (the "
                    "stage-wise path is already O(H) per iteration and "
                    "blocking would break its Riccati structure)")
            self._n_moves = len(move_schedule(spec.moves, spec.horizon))
        self._Hv = self._n_moves or spec.horizon
        if cfg is None:
            # MPC_CONFIG's small cold start (y0=0.01) matters: the
            # multiplicative update *grows* Y fast (ratio up to
            # Fd^-/Fd^+) but *decays* it slowly (ratio bounded below by
            # theta.Y/(theta.Y + Fd^+)), so the reference's Y0=1000
            # (PQP_CPU.c:710, tuned for its own example/) is
            # catastrophic here: on a double-integrator MPC QP it needs
            # ~51k iterations where Y0=0.01 needs 9 — same U*.
            cfg = (stagewise_mpc_config(spec.horizon)
                   if backend == "stagewise" else MPC_CONFIG)
        self.spec = spec
        self.warm_start = warm_start
        # An explicitly-passed cfg is honored verbatim; cold_start_y0
        # overrides only its y0 when given.
        self.cfg = cfg if cold_start_y0 is None else \
            dataclasses.replace(cfg, y0=cold_start_y0)
        # Zero is an *absorbing state* of the multiplicative update
        # (Y_i <- Y_i * ratio), so a warm start whose inactive multipliers
        # underflowed to exactly 0 can never re-activate a constraint when
        # the active set shifts between consecutive QPs — the solve then
        # stalls on an infeasible U.  Floor the carried multipliers at a
        # tiny positive value; growth back to O(1) is geometric and fast.
        self.warm_start_floor = warm_start_floor
        self.backend = backend
        self.retry_cold = retry_cold
        self._u_base = (jnp.zeros(spec.plant.n_input, jnp.float32)
                        if spec.u_prev is None
                        else jnp.asarray(spec.u_prev, jnp.float32))
        if backend == "stagewise":
            from pqp_for_mpc_tpu.models.stagewise import stagewise_dual
            # matrix-free geometry; the O((H*nu)^2) condensed blocks are
            # never built
            self._sd = stagewise_dual(spec,
                                      theta_floor=self.cfg.theta_floor)
            self.data = None
            self.Qp = None
            self._geom = None
        else:
            self.data = condense(spec)
            self.Qp = self.data.qp()    # exactly-built, never re-inverted
            # instance-invariant dual geometry (GQi, Qd, theta, splits)
            # is computed once; per-step solves only rebuild the forcing
            self._geom = dual_geometry(self.data.Gp, self.data.Qp_inv,
                                       theta_floor=self.cfg.theta_floor,
                                       precision=self.cfg.precision)
        self._Y = None
        self._rollout_fns = {}   # steps -> compiled scan closure

    def _sd_with_uprev(self, u_prev):
        """Stage-wise dual with the stage-0 slew bounds moved to
        ``u_prev`` (additive delta from the build-time base, mirroring
        the condensed path's Kp update in :meth:`step`)."""
        up = jnp.asarray(u_prev, jnp.float32).reshape(-1)
        delta = up - self._u_base
        Kp = self._sd.Kp.at[2, 0].add(delta).at[3, 0].add(-delta)
        # keep the stored anchor in sync with the rewritten Kp rows —
        # relinearize() reads sd.u_prev, not the rows (single source
        # of truth; stale anchors silently revert slew bounds)
        return dataclasses.replace(self._sd, Kp=Kp, u_prev=up)

    def reset(self):
        self._Y = None

    def _shift_multipliers(self, Y):
        """Shift each stage-structured multiplier block one control step
        forward (last stage repeated): the receding-horizon prediction at
        t+1 is the t prediction advanced by one stage, so shifted
        multipliers start closer to the new optimum than unshifted ones
        (measured ~13% fewer iterations on the double-integrator loop).

        Row layout (input_constraints + optional output rows): four
        (H, nu) blocks, then two (H, ny) output blocks when present.
        """
        spec = self.spec
        H, nu = spec.horizon, spec.plant.n_input
        ny = spec.plant.n_output
        Hi = self._Hv    # move blocking: input groups have n_moves rows
        Y2 = Y if Y.ndim == 2 else Y[:, None]

        def shift_block(block, steps, w):
            b = block.reshape(steps, w, -1)
            return jnp.concatenate([b[1:], b[-1:]], axis=0).reshape(
                steps * w, -1)

        segs, off = [], 0
        for _ in range(4):
            segs.append(shift_block(Y2[off:off + Hi * nu], Hi, nu))
            off += Hi * nu
        has_out = (self.data.Kx is not None) if self.data is not None \
            else (spec.y_min is not None or spec.y_max is not None)
        if has_out:
            # 2 output blocks, plus 2 slack-positivity blocks when soft
            # (both backends use the same 4-block layout); output rows
            # keep per-stage granularity even under move blocking
            n_blocks = 4 if spec.soft_penalty is not None else 2
            for _ in range(n_blocks):
                segs.append(shift_block(Y2[off:off + H * ny], H, ny))
                off += H * ny
        out = jnp.concatenate(segs, axis=0)
        return out if Y.ndim == 2 else out[:, 0]

    def step(self, x, d_seq=None, u_prev=None):
        """Solve one MPC QP; returns (u0, SolveResult).  ``x`` may be
        batched ``(ns, B)`` for scenario fan-outs."""
        H, nu = self.spec.horizon, self.spec.plant.n_input
        nd = self.spec.plant.n_dist
        if self.backend == "stagewise":
            return self._step_stagewise(x, d_seq, u_prev)
        D = (jnp.zeros(H * nd, jnp.float32) if d_seq is None
             else jnp.asarray(d_seq, jnp.float32).reshape(-1))
        data = self.data
        if u_prev is not None:
            # u_prev enters only the slew-row bounds additively
            # (input_constraints layout: [box+, box-, slew+, slew-]);
            # an additive update preserves any output-constraint rows
            # appended after them.  data.Kp already carries spec.u_prev
            # (the base), so apply only the DELTA from it.
            M = self._Hv * nu
            up = jnp.asarray(u_prev, jnp.float32).reshape(-1) - self._u_base
            e1u = jnp.zeros(M, jnp.float32).at[:nu].set(up)
            Kp = data.Kp.at[2 * M:3 * M].add(e1u).at[3 * M:4 * M].add(-e1u)
            data = dataclasses.replace(data, Kp=Kp)
        primal = data.assemble(x=jnp.asarray(x, jnp.float32), D=D, Qp=self.Qp)
        dual = dualize_forcing(self._geom, primal.Fp, primal.Mp, primal.Kp,
                               precision=self.cfg.precision)
        Y0 = None
        if self.warm_start and self._Y is not None:
            B = primal.Fp.shape[1] if primal.Fp.ndim == 2 else 1
            Yw = self._Y
            if self.warm_start == "shift":
                Yw = self._shift_multipliers(Yw)
            if Yw.shape[1] == B or Yw.shape[1] == 1:
                Y0 = jnp.maximum(Yw, self.warm_start_floor)
            # else: batch size changed since last step — cold start
        # certify-or-recover rides inside the solve dispatch (one compiled
        # retry graph, no per-step host sync on `converged` — the eager
        # path paid a host round trip per step here)
        # solve_auto: warm steps stay on the XLA while-loop path
        # (routing.py)
        res = solve_auto(primal, dual, Y0=Y0, cfg=self.cfg,
                         retry_cold=self.retry_cold and Y0 is not None)
        if self.warm_start:
            self._Y = res.Y
        u0 = res.U[:nu]
        return u0, res

    def _step_stagewise(self, x, d_seq=None, u_prev=None):
        """Matrix-free :meth:`step`: same warm-start/shift semantics,
        the solve runs :func:`pqp_for_mpc_tpu.models.stagewise.solve_stagewise`
        (O(H) memory, temporally-parallel KKT recursions)."""
        from pqp_for_mpc_tpu.models.stagewise import solve_stagewise
        spec = self.spec
        nu, nd = spec.plant.n_input, spec.plant.n_dist
        x2 = jnp.asarray(x, jnp.float32)
        x2 = x2 if x2.ndim == 2 else x2[:, None]
        B = x2.shape[1]
        dseq = None
        if d_seq is not None:
            dseq = jnp.asarray(d_seq, jnp.float32).reshape(
                spec.horizon, nd)[..., None]
            dseq = jnp.broadcast_to(dseq, (spec.horizon, nd, B))
        sd = self._sd if u_prev is None else self._sd_with_uprev(u_prev)
        Y0 = None
        if self.warm_start and self._Y is not None:
            Yw = self._Y
            if self.warm_start == "shift":
                Yw = self._shift_multipliers(Yw)
            if Yw.shape[1] in (B, 1):
                Y0 = jnp.maximum(Yw, self.warm_start_floor)
        res = solve_stagewise(sd, x2, dseq=dseq, Y0=Y0, cfg=self.cfg,
                              retry_cold=self.retry_cold and Y0 is not None)
        if self.warm_start:
            self._Y = res.Y
        u0 = res.U[:nu]
        return u0, res

    def rollout_jit(self, x0, steps: int, d_forecast=None, w_seq=None):
        """Fully-jitted closed loop: ``lax.scan`` over control steps with
        the PQP solve, constraint-vector rebuild (slew rows depend on the
        previous input) and plant propagation all in one compiled graph.

        This is the answer to BASELINE config 4 (1000-step
        receding-horizon rollout): the host-loop :meth:`rollout` pays a
        device round-trip per step, while this path runs the entire
        rollout in one dispatch.  The
        reference cannot express this at all — its solver is a main()
        per QP.

        ``d_forecast`` — optional known-disturbance PREVIEW, a
        ``(steps + H, nd)`` array (e.g. a weather forecast for the
        reference-style thermal plant, whose ambient temperature is
        exactly the ``D`` input the reference loads from file,
        PQP_CPU.c:757-930 / example/D.txt): at step t the solver sees
        the window ``d_forecast[t:t+H]`` as its predicted disturbance
        sequence and the plant propagates with ``d_forecast[t]``.
        Feedforward on known disturbances is standard production MPC;
        the reference's fixed-file pipeline can only bake one constant
        D into the forcing.

        ``w_seq`` — optional ``(steps, ns)`` additive PROCESS disturbance
        on the true state update (the robust tube's ``|w| <= w_box``;
        pair with :func:`~pqp_for_mpc_tpu.models.robust.robust_spec`).
        The solver never sees it — it hits only the simulated truth.

        Returns dict of stacked trajectories (x, u, iters, converged).
        Measurement noise is zero (use :meth:`rollout` for custom
        per-step callables, or
        :class:`~pqp_for_mpc_tpu.models.offset_free.OffsetFreeController`
        for UNMEASURED disturbances).
        """
        H, nd = self.spec.horizon, self.spec.plant.n_dist
        key = (steps, d_forecast is not None, w_seq is not None)
        run = self._rollout_fns.get(key)
        if run is None:
            run = self._build_rollout_fn(steps,
                                         with_preview=d_forecast is not None,
                                         with_w=w_seq is not None)
            self._rollout_fns[key] = run
        args = [jnp.asarray(x0, jnp.float32)]
        if w_seq is not None:
            args.append(jnp.asarray(w_seq, jnp.float32).reshape(
                steps, self.spec.plant.n_state))
        if d_forecast is not None:
            df = jnp.asarray(d_forecast, jnp.float32).reshape(-1, nd)
            if df.shape[0] < steps + H:
                raise ValueError(f"d_forecast needs {steps + H} rows "
                                 f"(steps + horizon), got {df.shape[0]}")
            # per-step preview windows (steps, H, nd) by vectorized gather
            idx = jnp.arange(steps)[:, None] + jnp.arange(H)[None, :]
            args.append(df[idx])
        xs, us, iters, conv = run(*args)
        return dict(x=np.asarray(xs), u=np.asarray(us),
                    iters=np.asarray(iters), converged=np.asarray(conv))

    def _check_lti_rollout(self):
        # The closed-loop propagation x+ = A x + B u0 reuses one (A, B);
        # an LTV prediction model has no single pair, and receding-
        # horizon use of one means re-linearizing every step anyway
        # (examples/nonlinear_mpc.py drives step() in that pattern).
        if np.asarray(self.spec.plant.A).ndim == 3:
            raise NotImplementedError(
                "closed-loop rollout needs an LTI plant; for LTV / "
                "successive-linearization loops call step() per control "
                "step (see examples/nonlinear_mpc.py)")

    @staticmethod
    def _scan_run(step, init_of, steps, with_w, with_preview):
        """Assemble the jitted lax.scan runner for the (w_seq, preview)
        combination: ``step(carry, win, w_t)`` with None for absent
        channels (shared by both backends' builders)."""
        @jax.jit
        def run(x0, *extra):
            ws = extra[0] if with_w else None
            wins = extra[-1] if with_preview else None
            scanned = tuple(a for a in (ws, wins) if a is not None)

            def body(cy, sc):
                i = 0
                w_t = sc[i] if with_w else None
                i += int(with_w)
                win = sc[i] if with_preview else None
                return step(cy, win, w_t)

            if scanned:
                _, traj = jax.lax.scan(body, init_of(x0), scanned)
            else:
                _, traj = jax.lax.scan(lambda cy, _: step(cy, None, None),
                                       init_of(x0), None, length=steps)
            return traj
        return run

    def _build_rollout_fn(self, steps: int, with_preview: bool = False,
                          with_w: bool = False):
        self._check_lti_rollout()
        if self.backend == "stagewise":
            return self._build_rollout_fn_stagewise(steps, with_preview,
                                                    with_w)
        spec, data, cfg = self.spec, self.data, self.cfg
        plant = spec.plant
        H, nu, nd = spec.horizon, plant.n_input, plant.n_dist
        M = self._Hv * nu    # = H*nu unless move blocking shrinks it

        A = jnp.asarray(plant.A, jnp.float32)
        Bm = jnp.asarray(plant.B, jnp.float32)
        Em = jnp.asarray(plant.E, jnp.float32)
        geom = self._geom
        N = data.n_con
        D0 = jnp.zeros(H * nd, jnp.float32)
        Qp = self.Qp
        floor = self.warm_start_floor

        u_base = self._u_base
        warm_mode = self.warm_start
        Y_cold = jnp.full((N, 1), cfg.y0, jnp.float32)

        def kp_of(u_prev):
            # additive u_prev DELTA on the slew rows of the base Kp
            # (which already carries spec.u_prev); keeps any output-
            # constraint rows appended after the 4M input rows
            e1u = jnp.zeros(M, jnp.float32).at[:nu].set(u_prev - u_base)
            return data.Kp.at[2 * M:3 * M].add(e1u) \
                          .at[3 * M:4 * M].add(-e1u)

        retry = self.retry_cold

        def step(carry, win, w_t=None):
            x, u_prev, Y = carry
            # win: (H, nd) preview window, or None (zero disturbance)
            D = D0 if win is None else win.reshape(-1)
            d2 = dataclasses.replace(data, Kp=kp_of(u_prev))
            primal = d2.assemble(x=x, D=D, Qp=Qp)
            dual = dualize_forcing(geom, primal.Fp, primal.Mp, primal.Kp,
                                   cfg.precision)
            # certify-or-recover (see __init__) runs INSIDE the solve —
            # one compiled solve graph, retry attempt taken only at
            # runtime.  (A lax.cond form would duplicate the whole
            # solve graph per scan step.)
            res = solve_auto(primal, dual,
                             Y0=jnp.maximum(Y, floor), cfg=cfg,
                             retry_cold=retry)
            u0 = res.U[:nu, 0]
            xn = A @ x + Bm @ u0
            if win is not None:
                xn = xn + Em @ win[0]
            if w_t is not None:
                xn = xn + w_t
            # next-step warm start honors the controller's mode
            if warm_mode == "shift":
                Yn = self._shift_multipliers(res.Y)
            elif warm_mode:
                Yn = res.Y
            else:
                Yn = Y_cold
            return (xn, u0, Yn), (xn, u0, res.iters[0],
                                  res.converged[0])

        init_of = lambda x0: (x0, jnp.zeros(nu, jnp.float32),
                              jnp.full((N, 1), cfg.y0, jnp.float32))
        return self._scan_run(step, init_of, steps, with_w, with_preview)

    def _build_rollout_fn_stagewise(self, steps: int,
                                    with_preview: bool = False,
                                    with_w: bool = False):
        """Stage-wise analog of :meth:`_build_rollout_fn`: the whole
        closed loop — matrix-free solve included — in one lax.scan."""
        from pqp_for_mpc_tpu.models.stagewise import solve_stagewise
        spec, cfg = self.spec, self.cfg
        plant = spec.plant
        nu = plant.n_input
        A = jnp.asarray(plant.A, jnp.float32)
        Bm = jnp.asarray(plant.B, jnp.float32)
        Em = jnp.asarray(plant.E, jnp.float32)
        sd0 = self._sd
        u_base = self._u_base
        floor = self.warm_start_floor
        warm_mode = self.warm_start
        N = sd0.n_con
        Y_cold = jnp.full((N, 1), cfg.y0, jnp.float32)

        retry = self.retry_cold

        def step(carry, win, w_t=None):
            x, u_prev, Y = carry
            delta = u_prev - u_base
            Kp = sd0.Kp.at[2, 0].add(delta).at[3, 0].add(-delta)
            # u_prev kept in sync with the Kp rows (relinearize reads it)
            sd = dataclasses.replace(sd0, Kp=Kp, u_prev=u_prev)
            # certify-or-recover inside the solve dispatch (see the
            # condensed rollout's comment; same single-call-site fix)
            dseq = None if win is None else win[..., None]  # (H, nd, 1)
            res = solve_stagewise(sd, x[:, None], dseq=dseq,
                                  Y0=jnp.maximum(Y, floor), cfg=cfg,
                                  retry_cold=retry)
            u0 = res.U[:nu, 0]
            xn = A @ x + Bm @ u0
            if win is not None:
                xn = xn + Em @ win[0]
            if w_t is not None:
                xn = xn + w_t
            if warm_mode == "shift":
                Yn = self._shift_multipliers(res.Y)
            elif warm_mode:
                Yn = res.Y
            else:
                Yn = Y_cold
            return (xn, u0, Yn), (xn, u0, res.iters[0],
                                  res.converged[0])

        init_of = lambda x0: (x0, jnp.zeros(nu, jnp.float32),
                              jnp.full((N, 1), cfg.y0, jnp.float32))
        return self._scan_run(step, init_of, steps, with_w, with_preview)

    def rollout(self, x0, steps: int, d_fn=None, noise=None):
        """Closed-loop simulation for ``steps`` steps (BASELINE config 4).

        Returns dict with state/input/iteration trajectories.
        """
        self._check_lti_rollout()
        plant = self.spec.plant
        x = jnp.asarray(x0, jnp.float32)
        u_prev = jnp.zeros(plant.n_input, jnp.float32)
        xs, us, iters = [], [], []
        for t in range(steps):
            d_seq = None if d_fn is None else d_fn(t)
            u0, res = self.step(x, d_seq=d_seq, u_prev=u_prev)
            u0v = u0[:, 0] if u0.ndim == 2 else u0
            d_now = (None if d_fn is None else
                     jnp.asarray(d_fn(t), jnp.float32).reshape(
                         self.spec.horizon, plant.n_dist)[0])
            x = plant.step(np.asarray(x), np.asarray(u0v),
                           None if d_now is None else np.asarray(d_now))
            if noise is not None:
                x = x + noise(t)
            x = jnp.asarray(x, jnp.float32)
            u_prev = u0v
            xs.append(np.asarray(x))
            us.append(np.asarray(u0v))
            iters.append(int(np.asarray(res.iters).max()))
        return dict(x=np.stack(xs), u=np.stack(us), iters=np.array(iters))
