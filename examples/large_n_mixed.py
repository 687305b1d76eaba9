"""Mixed-precision solving of large constraint systems (solve_mixed).

The reference's largest fixture is N=1500 (testing/sample test/
test1.txt) and its GPU fusion ceiling is one update's two matvecs per
launch (PQP_Fusion.cu:772-846).  At large N each update is one
``(N, N) @ (N, B)`` matrix product, and ``solve_mixed`` runs the BULK of
the iterations against a consistently-rounded bfloat16 copy of the dual
Hessian (bf16 operands, f32 accumulation) — then refines and CERTIFIES
in float32 on the true problem.

This example runs a small instance so it executes anywhere (the CPU
backend emulates bf16); point --n at 4096 on a GPU to see the real
effect, or run ``python benchmarks/bench_mixed.py``.

    python examples/large_n_mixed.py [--n 384] [--b 8]
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))   # run me from anywhere

import argparse
import time
from functools import partial

import numpy as np

import jax

from pqp_for_mpc_tpu import SolverConfig, solve_batched, solve_mixed
from pqp_for_mpc_tpu.dual import dualize
from pqp_for_mpc_tpu.io.generator import gaussian_batch


def build(N, M, B, seed=0):
    primal = gaussian_batch(N, M, B, seed)
    # split-free geometry: this example only runs the XLA and mixed
    # engines, which never need the materialized Qd+-theta matrices —
    # skipping them halves the dual's memory at large N
    return primal, dualize(primal, materialize_splits=False)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=384)
    ap.add_argument("--b", type=int, default=8)
    args = ap.parse_args()
    N, M, B = args.n, args.n // 4, args.b

    primal, dual = build(N, M, B)
    cfg = SolverConfig(max_iters=30000, check_every=16, accel_every=16,
                       strict_weak_duality=False,
                       gap_from_complementarity=True)
    # ALWAYS jit solve_mixed and pass (primal, dual) as arguments —
    # closed over, the bf16 geometry re-materializes per call
    runs = {"f32      ": jax.jit(partial(solve_batched, cfg=cfg)),
            "mixed    ": jax.jit(partial(solve_mixed, cfg=cfg))}
    out = {}
    for name, fn in runs.items():
        jax.block_until_ready(fn(primal, dual))      # compile + warm-up
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn(primal, dual))
        out[name] = (time.perf_counter() - t0, r)
        print(f"{name}: {out[name][0]*1e3:8.1f} ms   "
              f"certified {int(np.asarray(r.converged).sum())}/{B}   "
              f"iters {float(np.asarray(r.iters).mean()):.0f}")

    (t32, r32), (tmx, rmx) = out.values()
    both = np.asarray(r32.converged) & np.asarray(rmx.converged)
    dU = float(np.abs(np.asarray(r32.U) - np.asarray(rmx.U))[:, both].max())
    print(f"speedup {t32/tmx:.2f}x   max |dU| {dU:.3g} "
          f"(certification is float32 on the TRUE problem either way)")
    assert bool(np.asarray(rmx.converged).all())
    assert dU < 1e-3


if __name__ == "__main__":
    main()
