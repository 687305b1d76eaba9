"""Primal -> dual transform and the PQP matrix splits.

Batched rendition of the reference's problem-build layer
(``convertToDual`` PQP_CPU.c:489-498, ``computeTheta`` PQP_CPU.c:503-519,
``computeQdp_theta``/``computeQdn_theta`` PQP_CPU.c:524-537 and the Fd split
at PQP_CPU.c:703-704).  Everything is a handful of GEMMs and elementwise
splits — exactly what XLA fuses and hands to its matrix libraries; no
kernel needed here (the hot loop lives in :mod:`pqp_for_mpc_tpu.solver`
/ ``ops``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from pqp_for_mpc_tpu.problem import DualQP, PrimalQP


def _prec(precision: str):
    return lax.Precision.HIGHEST if precision == "highest" else None


@partial(jax.jit, static_argnames=("theta_floor", "precision",
                                   "materialize_splits"))
def dualize(primal: PrimalQP, theta_floor: float = 5.0,
            precision: str = "highest",
            materialize_splits: bool = True) -> DualQP:
    """Build the non-negative dual QP and its PQP split from the primal.

    * ``Qd = Gp Qp^-1 Gp'``        (computeQd, PQP_CPU.c:440-443)
    * ``Fd = Gp Qp^-1 Fp + Kp``    (computeFd, PQP_CPU.c:456-460)
    * ``Md = Fp' Qp^-1 Fp - Mp``   (computeMd, PQP_CPU.c:472-479)
    * ``theta_i = max(rowsum(max(0,-Qd))_i, theta_floor)``
      — satisfies the PQP requirement theta_ii >= (Qd^-)_ii
      (computeTheta + diagonalAdd, PQP_CPU.c:503-519, 235-242; floor 5.0
      in the root variants, 100.0 in the benchmark harnesses)
    * ``Qd^{+/-} + theta`` and ``Fd^{+/-}`` elementwise splits.

    Batched ``Fp (M, B)`` / ``Mp (B,)`` yield batched ``Fd (N, B)`` /
    ``Md (B,)`` with the instance-invariant pieces (Qd, theta, Qd splits)
    shared — the key structure exploited by the batched solver: one
    ``(N, N) @ (N, B)`` matrix product updates the whole batch.

    ``materialize_splits=False`` skips the two ``Qd^{+/-} + theta``
    matrices — HALVING the geometry's memory (2 x N^2 f32; 536 MB at
    N=8192) — and the XLA solve computes the splits on the fly inside
    the update's dot.  The float program differs from the materialized
    one only in where the theta term accumulates (inside the dot vs a
    separate f32 add), so razor-edge verdicts can flip at float-noise
    scale; the reference-conformance default keeps materialized splits.
    The whole-solve GPU kernel and row-sharded solves require
    materialized splits; ``solve_batched`` and ``solve_mixed`` never
    need them.
    """
    geom = dual_geometry(primal.Gp, primal.Qp_inv,
                         theta_floor=theta_floor, precision=precision,
                         materialize_splits=materialize_splits)
    return dualize_forcing(geom, primal.Fp, primal.Mp, primal.Kp,
                           precision=precision)


def dual_geometry(Gp: jax.Array, Qp_inv: jax.Array,
                  theta_floor: float = 5.0, precision: str = "highest",
                  materialize_splits: bool = True):
    """The instance-invariant half of :func:`dualize`: everything that
    depends only on the constraint geometry (Gp, Qp) — ``GQi = Gp Qp^-1``,
    ``Qd``, ``theta`` and the Qd splits.  Compute once per problem
    geometry and reuse across receding-horizon steps / scenario batches
    via :func:`dualize_forcing` (the reference recomputes the full dual
    every solve, convertToDual PQP_CPU.c:489-498)."""
    p = _prec(precision)
    GQi = jnp.matmul(Gp, Qp_inv, precision=p)              # (N, M)
    Qd = jnp.matmul(GQi, Gp.T, precision=p)                # (N, N)
    Qd_neg = jnp.maximum(-Qd, 0.0)
    theta = jnp.maximum(jnp.sum(Qd_neg, axis=1), theta_floor)
    if not materialize_splits:
        return dict(GQi=GQi, Qd=Qd, theta=theta,
                    Qdp_theta=None, Qdn_theta=None, Qp_inv=Qp_inv)
    eye_theta = jnp.diag(theta)
    return dict(GQi=GQi, Qd=Qd, theta=theta,
                Qdp_theta=jnp.maximum(Qd, 0.0) + eye_theta,
                Qdn_theta=Qd_neg + eye_theta, Qp_inv=Qp_inv)


def dualize_forcing(geom: dict, Fp: jax.Array, Mp: jax.Array,
                    Kp: jax.Array, precision: str = "highest") -> DualQP:
    """The per-instance half of :func:`dualize`: ``Fd = GQi Fp + Kp``,
    ``Md = Fp'Qp^-1 Fp - Mp`` and the Fd split, given precomputed
    :func:`dual_geometry`.  ``Fp`` may be ``(M,)`` or ``(M, B)``;
    ``Mp`` scalar or ``(B,)``."""
    p = _prec(precision)
    batched = Fp.ndim == 2 or Kp.ndim == 2
    Fp2 = Fp if Fp.ndim == 2 else Fp[:, None]
    Kp2 = Kp if Kp.ndim == 2 else Kp[:, None]
    Fd = jnp.matmul(geom["GQi"], Fp2, precision=p) + Kp2
    QiF = jnp.matmul(geom["Qp_inv"], Fp2, precision=p)
    Md = jnp.sum(Fp2 * QiF, axis=0) - Mp
    if not batched:
        Fd = Fd[:, 0]
        Md = Md[0] if Md.ndim else Md
    return DualQP(Qd=geom["Qd"], Fd=Fd, Md=Md, theta=geom["theta"],
                  Qdp_theta=geom["Qdp_theta"], Qdn_theta=geom["Qdn_theta"],
                  Fdp=jnp.maximum(Fd, 0.0), Fdn=jnp.maximum(-Fd, 0.0))


@partial(jax.jit, static_argnames=("theta_floor", "precision",
                                   "materialize_splits"))
def dualize_distinct(primal: PrimalQP, theta_floor: float = 5.0,
                     precision: str = "highest",
                     materialize_splits: bool = True) -> DualQP:
    """:func:`dualize` for a batch of fully distinct instances — the
    reference's own benchmark workload is exactly this shape (one random
    geometry per instance, testing/test_generator.c:997-998).

    Conventions: matrices carry a LEADING batch axis (``Qp (B, M, M)``,
    ``Gp (B, N, M)``), vectors a TRAILING one (``Fp (M, B)``,
    ``Kp (N, B)`` or shared ``(N,)``) — matching what
    :func:`pqp_for_mpc_tpu.solver.solve_batched`'s einsum path consumes.

    ``materialize_splits=False`` skips the ``Qd^± + θ`` matrices
    (``None`` in the result) — at large N each split is ``B·N²·4``
    bytes, and ``solve_batched``/``solve_mixed`` only need ``Qd`` +
    ``theta``.
    """
    p = _prec(precision)
    B = primal.Qp.shape[0]
    N = primal.Gp.shape[1]
    Fp2 = primal.Fp if primal.Fp.ndim == 2 else \
        jnp.broadcast_to(primal.Fp[:, None], (primal.Fp.shape[0], B))
    Kp2 = primal.Kp if primal.Kp.ndim == 2 else primal.Kp[:, None]
    GQi = jnp.einsum("bnm,bmk->bnk", primal.Gp, primal.Qp_inv, precision=p)
    Qd = jnp.einsum("bnm,bkm->bnk", GQi, primal.Gp, precision=p)
    theta = jnp.maximum(jnp.sum(jnp.maximum(-Qd, 0.0), axis=2),
                        theta_floor)                            # (B, N)
    Fd = jnp.einsum("bnm,mb->nb", GQi, Fp2, precision=p) + Kp2
    QiF = jnp.einsum("bmk,kb->mb", primal.Qp_inv, Fp2, precision=p)
    Md = jnp.sum(Fp2 * QiF, axis=0) - primal.Mp
    Qdp_theta = Qdn_theta = None
    if materialize_splits:
        eye = jnp.eye(N, dtype=Qd.dtype)
        Qdp_theta = jnp.maximum(Qd, 0.0) + theta[:, :, None] * eye
        Qdn_theta = jnp.maximum(-Qd, 0.0) + theta[:, :, None] * eye
    return DualQP(Qd=Qd, Fd=Fd, Md=Md, theta=theta,
                  Qdp_theta=Qdp_theta, Qdn_theta=Qdn_theta,
                  Fdp=jnp.maximum(Fd, 0.0), Fdn=jnp.maximum(-Fd, 0.0))


def primal_from_dual(primal: PrimalQP, Y: jax.Array,
                     precision: str = "highest") -> jax.Array:
    """Recover the primal iterate ``U = -Qp^-1 (Fp + Gp' Y)``
    (computeUfromY, PQP_CPU.c:352-360).  ``Y`` may be ``(N,)`` or ``(N, B)``.
    """
    p = _prec(precision)
    Yc = Y if Y.ndim == 2 else Y[:, None]
    Fp = primal.Fp if primal.Fp.ndim == 2 else primal.Fp[:, None]
    tmp = jnp.matmul(primal.Gp.T, Yc, precision=p) + Fp
    U = -jnp.matmul(primal.Qp_inv, tmp, precision=p)
    return U if Y.ndim == 2 else U[:, 0]
