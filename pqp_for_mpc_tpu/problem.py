"""QP problem containers (JAX pytrees).

The reference passes ~20 raw ``float*`` buffers through every call
(``PQP_CPU.c:694``, ``PQP_CPU.c:935-996``).  Here the same data is grouped
into three registered-pytree dataclasses so they flow through ``jit`` /
``vmap`` / sharding transparently:

* :class:`CondensedMPCData` — the 16-matrix condensed-MPC instance the
  reference reads from ``example/*.txt`` (``PQP_CPU.c:757-930``).
* :class:`PrimalQP` — the assembled primal QP
  ``min 1/2 U'Qp U + Fp'U + 1/2 Mp  s.t.  Gp U <= Kp`` (``PQP_CPU.c:5-6``).
* :class:`DualQP` — its non-negative dual plus the precomputed PQP split
  (Qd^+ + theta, Qd^- + theta, Fd^+, Fd^-), ref ``PQP_CPU.c:503-537,703-708``.

Shape conventions (row-major, "math" orientation — the loaders undo the
reference's column-major file layout):

* ``M`` — number of primal variables (inputs over the horizon).
* ``N`` — number of constraints (= dual dimension).
* Batched solves put the batch LAST: ``Y: (N, B)`` so each PQP update is an
  ``(N, N) @ (N, B)`` matrix product with the batch on the trailing
  dimension.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp


def _pytree_dataclass(cls=None, *, meta_fields=()):
    """dataclass + jax pytree registration (data fields are leaves)."""

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        data_fields = [f.name for f in dataclasses.fields(c) if f.name not in meta_fields]
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=list(meta_fields)
        )
        return c

    return wrap if cls is None else wrap(cls)


@_pytree_dataclass
class PrimalQP:
    """Primal QP:  min_U 1/2 U'Qp U + Fp'U + 1/2 Mp   s.t.  Gp U <= Kp.

    ``Qp_inv`` is carried alongside ``Qp`` because both the dualization
    (``convertToDual``, PQP_CPU.c:489-498) and the primal recovery
    (``computeUfromY``, PQP_CPU.c:352-360) consume the inverse, while the
    primal cost (``computeCost``, PQP_CPU.c:648-666) consumes Qp itself.
    """

    Qp: jax.Array       # (M, M)
    Qp_inv: jax.Array   # (M, M)
    Fp: jax.Array       # (M,) or (M, B)
    Mp: jax.Array       # () or (B,)
    Gp: jax.Array       # (N, M)
    Kp: jax.Array       # (N,) or (N, B) — batched when constraint bounds
                        # depend on the instance (e.g. output constraints
                        # whose slack depends on x)

    def qp(self) -> jax.Array:
        """The primal Hessian: the stored exactly-built ``Qp`` when
        present, else the inverse of ``Qp_inv`` (the reference's
        Gauss_Jordan step, PQP_CPU.c:989 — the only option for
        file-loaded instances)."""
        return (jnp.linalg.inv(self.Qp_inv) if self.Qp is None
                else self.Qp)

    @property
    def n_var(self) -> int:
        return self.Gp.shape[-1]

    @property
    def n_con(self) -> int:
        return self.Gp.shape[-2]


@_pytree_dataclass
class DualQP:
    """Dual QP  min_{Y>=0} 1/2 Y'Qd Y + Fd'Y + 1/2 Md  with the PQP split.

    Built by :func:`pqp_for_mpc_tpu.dual.dualize`:

    * ``Qd = Gp Qp^-1 Gp'``            (computeQd, PQP_CPU.c:440-443)
    * ``Fd = Gp Qp^-1 Fp + Kp``        (computeFd, PQP_CPU.c:456-460)
    * ``Md = Fp'Qp^-1 Fp - Mp``        (computeMd, PQP_CPU.c:472-479)
    * ``theta = diag(max(rowsum(Qd^-), floor))`` (computeTheta, PQP_CPU.c:503-519)
    * ``Qdp_theta = max(0, Qd) + theta``  (PQP_CPU.c:524-528)
    * ``Qdn_theta = max(0,-Qd) + theta``  (PQP_CPU.c:533-537)
    * ``Fdp = max(0, Fd)``, ``Fdn = max(0,-Fd)`` (PQP_CPU.c:703-704)
    """

    Qd: jax.Array         # (N, N)
    Fd: jax.Array         # (N,) or (N, B)
    Md: jax.Array         # () or (B,)
    theta: jax.Array      # (N,)  — diagonal only; the dense N x N theta of
                          # the reference is all zeros off-diagonal
    Qdp_theta: Optional[jax.Array]  # (N, N); None = on-the-fly splits
    Qdn_theta: Optional[jax.Array]  # (N, N)   (dualize's
                                    #  materialize_splits=False)
    Fdp: jax.Array        # like Fd
    Fdn: jax.Array        # like Fd

    @property
    def n_con(self) -> int:
        return self.Qd.shape[-1]


@_pytree_dataclass
class CondensedMPCData:
    """A condensed-MPC instance: everything the reference reads from
    ``example/`` (``input()``, PQP_CPU.c:757-930), in math orientation.

    The time-varying pieces (state ``x``, disturbance ``D``) assemble into a
    :class:`PrimalQP` via :meth:`assemble`:

    * ``Fp = Fp1 D + Fp2 x - Fp3``           (computeFp, PQP_CPU.c:373-382)
    * ``Mp`` per computeMp (PQP_CPU.c:395-428).  NOTE: the reference *code*
      adds the D'Mp2 x, Mp4 x and Mp5 D terms each with +1/2, although its
      docstring says ``+ D'Mp2 x - 1/2 Mp4 x - 1/2 Mp5 D`` (PQP_CPU.c:391 vs
      403-423).  The code's behavior is the oracle; we reproduce it.
    """

    Qp_inv: jax.Array  # (M, M)
    Fp1: jax.Array     # (M, nDis)
    Fp2: jax.Array     # (M, nState)
    Fp3: jax.Array     # (M,)
    Mp1: jax.Array     # (nState, nState)
    Mp2: jax.Array     # (nDis, nState)
    Mp3: jax.Array     # (nDis, nDis)
    Mp4: jax.Array     # (nState,)
    Mp5: jax.Array     # (nDis,)
    Mp6: jax.Array     # ()
    Gp: jax.Array      # (N, M)
    Kp: jax.Array      # (N,)
    Z: jax.Array       # (nOutput, nState)   — loaded but unused by the solve,
    ThetaOut: jax.Array  # (nOutput, nDis)   — kept for file-format parity
    x: jax.Array       # (nState,)
    D: jax.Array       # (nDis,)
    # Optional state-dependent constraint bounds (output constraints —
    # beyond the reference, whose Kp is constant):
    #   Kp(x, D) = Kp + Kx x + Kd D
    Kx: Optional[jax.Array] = None   # (N, nState)
    Kd: Optional[jax.Array] = None   # (N, H*nDis)
    # Optional exactly-built Qp.  File-loaded instances carry only
    # Qp_inv (the reference's input; Gauss_Jordan recovers Qp,
    # PQP_CPU.c:989) and leave this None; framework-condensed instances
    # store the float64-built Qp (models/mpc.py condense) because at
    # kappa(Qp) beyond 1/eps_f32 the inverse of an f32 Qp_inv no longer
    # determines Qp — re-inverting there is both slower (O(M^3)) and
    # catastrophically less accurate than remembering the matrix.
    Qp: Optional[jax.Array] = None   # (M, M)

    def qp(self) -> jax.Array:
        """The primal Hessian: the stored exactly-built ``Qp`` when
        present, else the inverse of ``Qp_inv`` (the reference's
        Gauss_Jordan step, PQP_CPU.c:989 — the only option for
        file-loaded instances)."""
        return (jnp.linalg.inv(self.Qp_inv) if self.Qp is None
                else self.Qp)

    @property
    def n_var(self) -> int:
        return self.Gp.shape[-1]

    @property
    def n_con(self) -> int:
        return self.Gp.shape[-2]

    def assemble(
        self,
        x: Optional[jax.Array] = None,
        D: Optional[jax.Array] = None,
        Qp: Optional[jax.Array] = None,
        precision=None,
    ) -> PrimalQP:
        """Build the PrimalQP for state ``x`` / disturbance ``D``.

        Batched: ``x`` may be ``(nState, B)`` and/or ``D`` ``(nDis, B)``;
        then ``Fp`` is ``(M, B)`` and ``Mp`` is ``(B,)``.

        ``Qp`` (the inverse of ``Qp_inv``) is computed on the fly if not
        supplied; supply it to amortize the inversion across assemblies
        (the reference inverts once in main, PQP_CPU.c:989).
        """
        x = self.x if x is None else x
        D = self.D if D is None else D
        dot = lambda a, b: jnp.matmul(a, b, precision=precision)

        batched = x.ndim == 2 or D.ndim == 2
        xc = x if x.ndim == 2 else x[:, None]          # (nState, B)
        Dc = D if D.ndim == 2 else D[:, None]          # (nDis, B)
        if xc.shape[-1] != Dc.shape[-1]:
            b = max(xc.shape[-1], Dc.shape[-1])
            xc = jnp.broadcast_to(xc, (*xc.shape[:-1], b))
            Dc = jnp.broadcast_to(Dc, (*Dc.shape[:-1], b))

        # Fp = Fp1 D + Fp2 x - Fp3            (PQP_CPU.c:373-382)
        Fp = dot(self.Fp1, Dc) + dot(self.Fp2, xc) - self.Fp3[:, None]

        # Mp per computeMp's actual arithmetic (PQP_CPU.c:395-428):
        #   1/2 x'Mp1 x + 1/2 D'Mp2 x + 1/2 Mp4·x + 1/2 D'Mp3 D + 1/2 Mp5·D
        #   + 1/2 Mp6
        xMp1x = jnp.einsum("sb,st,tb->b", xc, self.Mp1, xc, precision=precision)
        DMp2x = jnp.einsum("db,ds,sb->b", Dc, self.Mp2, xc, precision=precision)
        Mp4x = dot(self.Mp4[None, :], xc)[0]
        DMp3D = jnp.einsum("db,de,eb->b", Dc, self.Mp3, Dc, precision=precision)
        Mp5D = dot(self.Mp5[None, :], Dc)[0]
        Mp = 0.5 * (xMp1x + DMp2x + Mp4x + DMp3D + Mp5D + self.Mp6)

        if Qp is None:
            Qp = self.qp()
        Kp = self.Kp
        if self.Kx is not None:
            Kp = (Kp[:, None] + dot(self.Kx, xc)
                  + (dot(self.Kd, Dc) if self.Kd is not None else 0.0))
            if not batched:
                Kp = Kp[:, 0]
        if not batched:
            Fp = Fp[:, 0]
            Mp = Mp[0]
        return PrimalQP(Qp=Qp, Qp_inv=self.Qp_inv, Fp=Fp, Mp=Mp,
                        Gp=self.Gp, Kp=Kp)
