"""GPU bench: mixed-precision solve (bf16 bulk + f32 refine) vs the f32
XLA path at N=4096.

``solver.solve_mixed`` runs the bulk of the iterations against a
CONSISTENTLY-rounded bfloat16 copy of Qd (half the bytes per sweep, and
the bf16 matrix rate besides), hands off to the f32 solver at the bf16
floor, and certifies everything on the true float32 problem — same
four-part test, same tolerances.

Both paths are timed under jit with ``block_until_ready``; the mixed
path MUST be jitted — called eagerly it re-materializes the three bf16
matrices every call.

``--distinct`` switches to per-instance geometry (3-D ``Qd``, the
einsum path, bench_distinct's gaussian-Gp family at B=8) — there the
mixed phase's theta comes from each instance's own rounded rowsums.
The jitted callables take (primal, dual) as ARGUMENTS — closing over
them would bake hundreds of MB of constants into the compiled program.

Run: ``python benchmarks/bench_mixed.py [--n 4096] [--accel]
[--distinct]``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])
sys.path.insert(0, __file__.rsplit("/", 1)[0])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--b", type=int, default=128)
    ap.add_argument("--max-iters", type=int, default=30000)
    ap.add_argument("--check-every", type=int, default=16)
    ap.add_argument("--accel", action="store_true")
    ap.add_argument("--distinct", action="store_true",
                    help="per-instance geometry (3-D Qd, einsum path); "
                         "sizes default to 8 x N=2048/M=512")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--feas-gradient", action="store_true",
                    help="certify with the operator-consistent "
                         "feasibility (round 5): the check shares ONE "
                         "Qd pass between feasibility, costs and gap "
                         "instead of three, cutting the distinct "
                         "path's per-block f32 einsum overhead")
    args = ap.parse_args()

    import jax
    from functools import partial

    from pqp_for_mpc_tpu import (SolverConfig, dualize, solve_batched,
                                 solve_mixed)
    from pqp_for_mpc_tpu.io.generator import gaussian_batch

    if jax.devices()[0].platform != "gpu":
        sys.exit("bench_mixed.py: no GPU")
    k = args.check_every
    cfg = SolverConfig(max_iters=args.max_iters, check_every=k,
                       accel_every=k if args.accel else 0,
                       strict_weak_duality=False,
                       gap_from_complementarity=True)

    if args.distinct:
        from bench_distinct import make_instances
        from pqp_for_mpc_tpu.dual import dualize_distinct
        N, M, B = (2048 if args.n == 4096 else args.n,
                   512 if args.m == 1024 else args.m,
                   8 if args.b == 128 else args.b)
        cfg = SolverConfig(max_iters=args.max_iters, check_every=k,
                           accel_every=k if args.accel else 0,
                           strict_weak_duality=False,
                           gap_from_complementarity=True,
                           feas_from_dual_gradient=args.feas_gradient,
                           erc=1e-6, eac=1e-6, eaj=1e-6, erj=1e-6)
        primal = make_instances(B, M, N, seed=0, gaussian_gp=True)
        dual = dualize_distinct(primal, theta_floor=cfg.theta_floor)
    else:
        N, M, B = args.n, args.m, args.b
        primal = gaussian_batch(N, M, B)
        dual = dualize(primal)
    paths = {
        "f32_xla": jax.jit(partial(solve_batched, cfg=cfg)),
        "mixed": jax.jit(partial(solve_mixed, cfg=cfg)),
    }
    results, times = {}, {}
    for name, fn in paths.items():
        jax.block_until_ready(fn(primal, dual))     # compile + first run
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            r = jax.block_until_ready(fn(primal, dual))
            best = min(best, time.perf_counter() - t0)
        results[name], times[name] = r, best

    rx, rm = results["f32_xla"], results["mixed"]
    both = np.asarray(rx.converged) & np.asarray(rm.converged)
    row = {"bench": "mixed_precision_solve",
           "device_kind": jax.devices()[0].device_kind,
           "N": N, "M": M, "B": B, "max_iters": args.max_iters,
           "check_every": k, "accel": args.accel,
           "distinct": args.distinct, "mode": "complementarity",
           "feas_gradient": getattr(args, "feas_gradient", False)}
    for name in paths:
        r = results[name]
        row[f"{name}_s"] = times[name]
        row[f"{name}_converged"] = int(np.asarray(r.converged).sum())
        row[f"{name}_iters_mean"] = round(float(np.asarray(r.iters).mean()), 1)
    row["max_dU_mixed_vs_f32"] = float(np.max(
        np.abs(np.asarray(rm.U) - np.asarray(rx.U))[:, both], initial=0.0))
    row["speedup_vs_f32"] = times["f32_xla"] / times["mixed"]
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
