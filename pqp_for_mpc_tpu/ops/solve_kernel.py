"""Whole-solve GPU kernel: the entire batched PQP solve — multiplicative
updates, the periodic four-part termination check, divergence freeze
and early exit — in ONE kernel launch, written for Pallas through Triton.

Why a kernel: for example-sized problems (N=28 dual) each update is two
``(N, N) @ (N, B)`` products of about 7 flop per byte of ``Y``/``Fd``
traffic, so the XLA loop in :func:`pqp_for_mpc_tpu.solver.solve_batched`
streams the lane panels through device memory on every update, and
returns its ``all(done)`` predicate to the host on every check.  Here
one program owns a block of lanes for the whole solve: the matrices are
read from cache, the iterate stays in registers, and the panels are
read once per solve.  Measured on one H100 (700 W) at the example shape
(N=28, B=1,048,576, 555 iterations): 0.244 s against 0.461 s for
``solve_batched``.  The reference's best CUDA variant fuses one update's
two matvecs into one launch (``matrixMultiplyCuda_computeupdateY2``,
PQP_Fusion.cu:772-846) and still pays a launch per update plus two
blocking copies per check.

Semantics are those of ``solve_batched`` with ``accel_every=0``: the
same check-then-``check_every``-updates body, the same per-lane freeze
on certification or a non-finite iterate, and the same iteration
stamps, so both engines certify the same lanes at the same counts up to
float reduction order.  The exit diagnostics (``U``, costs,
feasibility, the exit-time verdict) come from the XLA helpers, which
keeps one source of truth for them.

Restrictions (:func:`fused_supports` is the test): shared geometry
(2-D ``Qd``) with materialized splits, ``N <= MAX_FUSED_N``, no
acceleration, and the reference's forcing-scale feasibility program
(not ``feas_from_dual_gradient``).

Padding: Triton's ``dot`` needs every dimension of its right operand to
be >= 16 and block shapes to be powers of two, so N and M are padded to
powers of two >= 16.  Padded dual coordinates have an identity diagonal
in both splits, zero forcing and ``Y = 1``: an exact fixed point of the
update that adds 0 to every reduction.  Padded lanes start frozen.

Precision: on this route an f32 ``dot`` at default precision lowers to
TF32 (about 10 mantissa bits); ``precision="highest"`` is passed
explicitly and lowers to IEEE float32 FMA.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

#: largest dual dimension the kernel takes.  Measured on one H100 (700 W)
#: at B=262,144 against solve_batched: N=64 1.23x faster, N=128 at best
#: 0.05x (every lane block and warp count tried spills); larger N stays
#: on XLA, whose update is then a GEMM
MAX_FUSED_N = 64

#: smallest extent of a Triton ``dot`` operand
_MIN_DOT = 16

# lane-state codes returned by the kernel
ACTIVE, CERTIFIED, DIVERGED, PADDING = 0, 1, 2, 3


def _pad_dim(n: int) -> int:
    return max(_MIN_DOT, pl.next_power_of_2(n))


def launch_shape(n_pad: int) -> tuple[int, int]:
    """(lanes per program, warps per program) for a padded dual of
    ``n_pad`` rows.  Swept on one H100 (700 W), N=28 at B=262,144: 16
    lanes per warp ran 0.063-0.073 s, 32 lanes per warp 0.89-1.48 s
    (XLA 0.135 s); N=64: only 16 lanes on 4 warps beat XLA."""
    return (64, 4) if n_pad <= 32 else (16, 4)


def fused_supports(dual, cfg) -> bool:
    """Whether :func:`solve_fused` takes this problem and configuration."""
    return (dual.Qd.ndim == 2 and dual.Qdn_theta is not None
            and dual.n_con <= MAX_FUSED_N and not cfg.accel_every
            and not cfg.feas_from_dual_gradient)


def _kernel(qdn_ref, qdp_ref, qd_ref, gpt_ref, gp_ref, qp_ref, qpi_ref,
            fp_ref, fd_ref, kps_ref, mp_ref, md_ref, y0_ref,
            y_out, it_out, st_out, *, n_lanes, cfg):
    from pqp_for_mpc_tpu.solver import termination_fail

    f32 = jnp.float32
    bb = y0_ref.shape[1]
    prec = lax.Precision.HIGHEST if cfg.precision == "highest" else None
    dot = lambda a, b: jnp.dot(a, b, precision=prec,
                               preferred_element_type=f32)
    count = lambda m: jnp.sum(m.astype(f32), axis=0)

    def update(y, active):
        fd = fd_ref[...]
        num = dot(qdn_ref[...], y) + jnp.maximum(-fd, 0.0)
        den = dot(qdp_ref[...], y) + jnp.maximum(fd, 0.0)
        if cfg.den_eps:
            den = jnp.maximum(den, cfg.den_eps)
        return jnp.where(active[None, :], (num / den) * y, y)

    def certified(y):
        fp = fp_ref[...]
        fd = fd_ref[...]
        u = -dot(qpi_ref[...], dot(gpt_ref[...], y) + fp)
        # ~(a <= b) counts NaN as a violation, as jnp.all(a <= b) does
        feas = count(~(dot(gp_ref[...], u) <= kps_ref[...])) == 0.0
        qdy = dot(qd_ref[...], y)
        jd = (0.5 * jnp.sum(y * qdy, axis=0) + jnp.sum(fd * y, axis=0)
              + 0.5 * md_ref[...])
        jp = (0.5 * jnp.sum(u * dot(qp_ref[...], u), axis=0)
              + jnp.sum(fp * u, axis=0) + 0.5 * mp_ref[...])
        gap = (jnp.sum(y * (qdy + fd), axis=0)
               if cfg.gap_from_complementarity else None)
        return ~termination_fail(feas, jp, jd, cfg, gap)

    def body(carry):
        h, y, st, it = carry
        active = st == ACTIVE
        bad = (count(~jnp.isfinite(y)) > 0.0) & active
        ok = certified(y) & active & ~bad
        it = jnp.where(ok | bad, h, it)
        st = jnp.where(ok, CERTIFIED, jnp.where(bad, DIVERGED, st))
        active = st == ACTIVE
        y = lax.fori_loop(0, cfg.check_every,
                          lambda _, z: update(z, active), y)
        return h + cfg.check_every, y, st, it

    def cond(carry):
        h, _, st, _ = carry
        n_active = jnp.sum((st == ACTIVE).astype(jnp.int32))
        return (n_active > 0) & (h <= cfg.max_iters)

    lane = pl.program_id(0) * bb + jnp.arange(bb, dtype=jnp.int32)
    st0 = jnp.where(lane < n_lanes, ACTIVE, PADDING).astype(jnp.int32)
    it0 = jnp.zeros((bb,), jnp.int32)
    h, y, st, it = lax.while_loop(
        cond, body, (jnp.int32(1), y0_ref[...], st0, it0))
    y_out[...] = y
    it_out[...] = jnp.where(st == ACTIVE, h, it)
    st_out[...] = st


@functools.partial(jax.jit, static_argnames=("cfg", "interpret"))
def solve_fused(primal, dual, Y0=None, cfg=None, interpret: bool = False):
    """Drop-in for :func:`pqp_for_mpc_tpu.solver.solve_batched` on a
    shared-geometry batch (see :func:`fused_supports`), running the
    whole solve in one kernel launch.  ``interpret=True`` runs the
    kernel in the Pallas interpreter (tests on a machine without a
    GPU).  Returns a :class:`~pqp_for_mpc_tpu.solver.SolveResult`."""
    from pqp_for_mpc_tpu.config import SolverConfig
    from pqp_for_mpc_tpu.solver import SolveResult, _as2d, check_terminate

    cfg = cfg or SolverConfig()
    if not fused_supports(dual, cfg):
        raise ValueError(
            "solve_fused takes shared 2-D Qd with materialized splits "
            f"(dualize(materialize_splits=True)), N <= {MAX_FUSED_N}, "
            "accel_every=0 and feas_from_dual_gradient=False; use "
            "solve_batched")
    f32 = jnp.float32
    N = dual.n_con
    M = primal.Gp.shape[1]
    B = _as2d(dual.Fd).shape[1]
    if Y0 is not None:
        Y0 = _as2d(Y0)
        if B > 1 and Y0.shape[1] not in (1, B):
            raise ValueError(
                f"warm start batch {Y0.shape[1]} != instance batch {B}")
        B = max(B, Y0.shape[1])
    n_pad, m_pad = _pad_dim(N), _pad_dim(M)
    bb, num_warps = launch_shape(n_pad)
    b_pad = -(-B // bb) * bb
    dn, dm, db = n_pad - N, m_pad - M, b_pad - B

    def square(A, n, n_p, diag):
        out = jnp.pad(A, ((0, n_p - n), (0, n_p - n)))
        pad_idx = jnp.arange(n, n_p)
        return out.at[pad_idx, pad_idx].set(diag) if diag else out

    def panel(v, rows, fill=0.0):
        v = jnp.broadcast_to(_as2d(v), (rows, B)).astype(f32)
        return jnp.pad(v, ((0, _pad_dim(rows) - rows), (0, db)),
                       constant_values=fill)

    def lanes(v):
        return jnp.pad(jnp.broadcast_to(v, (B,)).astype(f32), (0, db))

    Gp = jnp.pad(primal.Gp, ((0, dn), (0, dm)))
    y0 = jnp.full((N, B), cfg.y0, f32) if Y0 is None else Y0
    kp_slack = primal.Kp + jnp.maximum(cfg.erc * primal.Kp, cfg.eac)
    operands = (
        square(dual.Qdn_theta, N, n_pad, 1.0),
        square(dual.Qdp_theta, N, n_pad, 1.0),
        square(dual.Qd, N, n_pad, 0.0),
        Gp.T, Gp,
        square(primal.Qp, M, m_pad, 1.0),
        square(primal.Qp_inv, M, m_pad, 1.0),
        panel(primal.Fp, M), panel(dual.Fd, N),
        panel(kp_slack, N, fill=jnp.inf),
        lanes(primal.Mp), lanes(dual.Md),
        panel(y0, N, fill=1.0))

    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0, 0))
    lane_panel = lambda rows: pl.BlockSpec((rows, bb), lambda i: (0, i))
    lane_row = pl.BlockSpec((bb,), lambda i: (i,))
    in_specs = ([whole(a) for a in operands[:7]]
                + [lane_panel(m_pad)] + [lane_panel(n_pad)] * 2
                + [lane_row] * 2 + [lane_panel(n_pad)])
    Y, iters, state = pl.pallas_call(
        functools.partial(_kernel, n_lanes=B, cfg=cfg),
        grid=(b_pad // bb,),
        in_specs=in_specs,
        out_specs=[lane_panel(n_pad), lane_row, lane_row],
        out_shape=[jax.ShapeDtypeStruct((n_pad, b_pad), f32),
                   jax.ShapeDtypeStruct((b_pad,), jnp.int32),
                   jax.ShapeDtypeStruct((b_pad,), jnp.int32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name="pqp_whole_solve",
    )(*operands)
    Y, iters, state = Y[:N, :B], iters[:B], state[:B]

    prec = lax.Precision.HIGHEST if cfg.precision == "highest" else None
    ok, U, feas, Jp, Jd = check_terminate(primal, dual, Y, cfg, prec)
    div = (state == DIVERGED) | ~jnp.all(jnp.isfinite(Y), axis=0)
    return SolveResult(U=U, Y=Y, iters=iters,
                       converged=((state == CERTIFIED) | ok) & ~div,
                       feasible=feas, Jp=Jp, Jd=Jd, diverged=div)
