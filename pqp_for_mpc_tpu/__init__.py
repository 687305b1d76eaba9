"""pqp_for_mpc_tpu — a batched Parallel Quadratic Programming (PQP) engine for linear MPC.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of the reference
CUDA/C project ``yashsoni501/PQP-for-MPC`` (Di Cairano & Brand multiplicative dual
update for the condensed-MPC QP; see reference ``pseudocode.txt:1-35``):

* :mod:`pqp_for_mpc_tpu.problem`   — primal/dual QP containers (JAX pytrees).
* :mod:`pqp_for_mpc_tpu.dual`      — condensed build + primal->dual transform
  (ref ``PQP_CPU.c:373-498``), jitted.
* :mod:`pqp_for_mpc_tpu.solver`    — the PQP multiplicative-update solver
  (ref ``PQP_CPU.c:590-750``) as a ``lax.while_loop`` with batched instances,
  masked convergence and warm starting.
* :mod:`pqp_for_mpc_tpu.ops`       — the whole-solve GPU kernel (Pallas
  through Triton) for small-N batches: the fused CUDA kernel
  ``PQP_Fusion.cu:772-846`` extended across iterations and checks.
* :mod:`pqp_for_mpc_tpu.models`    — LTI plant zoo + condensed-MPC matrix
  derivation and receding-horizon closed loop (the reference loads
  precomputed blocks; we derive them).
* :mod:`pqp_for_mpc_tpu.parallel`  — device-mesh sharding: data-parallel
  instance batches and model-parallel (row-sharded dual Hessian) solves.
* :mod:`pqp_for_mpc_tpu.io`        — loaders for the reference's ``example/``
  text format (exact column-major semantics of ``PQP_CPU.c:757-930``) and the
  random-instance generator format (``testing/test_generator.c:936-987``).
* :mod:`pqp_for_mpc_tpu.native`    — ctypes bindings to the in-repo C++
  conformance oracle (``native/pqp_oracle.cpp``).
"""

__version__ = "0.1.0"

from pqp_for_mpc_tpu.problem import PrimalQP, DualQP, CondensedMPCData  # noqa: F401
from pqp_for_mpc_tpu.config import SolverConfig  # noqa: F401
from pqp_for_mpc_tpu.dual import dualize  # noqa: F401
from pqp_for_mpc_tpu.solver import (solve, solve_batched,  # noqa: F401
                                    solve_mixed, SolveResult)
from pqp_for_mpc_tpu.routing import route_solve, solve_auto  # noqa: F401
from pqp_for_mpc_tpu.diff import solve_qp_implicit  # noqa: F401
