"""On-GPU engine conformance sweep: the whole-solve kernel and the
mixed-precision path against the XLA solver.

The kernel's correctness tests run in interpret mode on CPU
(tests/test_solve_kernel.py); compiled for the GPU it is a different
float program.  This script runs every engine on the GPU against
``solve_batched`` across N ∈ {32 … 2048} and records lane-for-lane
parity: iteration counts, convergence flags, max |ΔU|, and in reference
mode an f64 audit of every verdict disagreement.

Run: ``python benchmarks/conformance.py [--sizes 32,64,...]``.
One JSON line per size and mode; exit code 1 if any fails its bars.
"""

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

#: Each engine's ENTIRE solve including the four-part check is an
#: independent float program, so
#: iteration counts on razor-edge lanes legitimately differ — the same
#: property the reference's own CPU/GPU variant pairs have (its two
#: committed U* snapshots differ in the 3rd decimal,
#: PQP_GPU_optimized_coarsened.cu:1201-1216).  The correctness bars are
#: solution agreement and a bounded converged-count gap; the per-lane
#: iteration-count match fractions are recorded as data.
PARITY_U_ATOL = 5e-3         # max |U_engine - U_xla| on converged lanes
PARITY_CONV_GAP_FRAC = 0.10  # |conv_engine - conv_xla| <= 10% of batch


def f64_gap_audit(primal, dual, Y, lanes):
    """Recompute the EXPLICIT duality gap in float64 on the host for the
    given lanes of an f32 iterate, plus the f32 noise floor of the
    explicit-form program (eps32 * the largest term magnitude entering
    the Jp + Jd cancellation).  A lane whose |f64 gap| sits below the
    floor has a verdict that NO f32 explicit-form program can make
    reliably — two independent float programs must be allowed to
    disagree on it."""
    if not lanes.any():
        return dict(n=0)
    f64 = np.float64
    Qp = np.asarray(primal.Qp, f64)
    Qpi = np.asarray(primal.Qp_inv, f64)
    Gp = np.asarray(primal.Gp, f64)
    Fp = np.asarray(primal.Fp, f64)
    Fp = Fp[:, lanes] if Fp.ndim == 2 else Fp[:, None]
    Qd = np.asarray(dual.Qd, f64)
    Fd = np.asarray(dual.Fd, f64)
    Fd = Fd[:, lanes] if Fd.ndim == 2 else Fd[:, None]
    Mp = np.asarray(primal.Mp, f64)
    Mp = Mp[lanes] if Mp.ndim else Mp
    Md = np.asarray(dual.Md, f64)
    Md = Md[lanes] if Md.ndim else Md
    Yl = np.asarray(Y, f64)[:, lanes]
    U = -Qpi @ (Fp + Gp.T @ Yl)
    t_jp_q = 0.5 * np.sum(U * (Qp @ U), axis=0)
    t_jp_f = np.sum(Fp * U, axis=0)
    t_jd_q = 0.5 * np.sum(Yl * (Qd @ Yl), axis=0)
    t_jd_f = np.sum(Fd * Yl, axis=0)
    gap = t_jp_q + t_jp_f + 0.5 * Mp + t_jd_q + t_jd_f + 0.5 * Md
    floor = np.finfo(np.float32).eps * np.max(
        np.abs(np.stack([t_jp_q, t_jp_f, 0.5 * Mp + 0 * gap,
                         t_jd_q, t_jd_f, 0.5 * Md + 0 * gap])), axis=0)
    return dict(n=int(lanes.sum()),
                gap_f64_max=float(np.abs(gap).max()),
                noise_floor_min=float(floor.min()),
                below_floor_frac=float((np.abs(gap) <= floor).mean()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="32,64,128,256,512,1024,2048")
    ap.add_argument("--b", type=int, default=128)
    ap.add_argument("--max-iters", type=int, default=20000)
    args = ap.parse_args()

    import jax

    from pqp_for_mpc_tpu import SolverConfig, dualize
    from pqp_for_mpc_tpu.io.generator import gaussian_batch
    from pqp_for_mpc_tpu.ops.solve_kernel import fused_supports, solve_fused
    from pqp_for_mpc_tpu.solver import solve_batched, solve_mixed

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"conformance.py: no GPU (JAX found {dev.platform})")

    def timed(fn):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn())
        return time.perf_counter() - t0, r

    ok_all = True
    for N in [int(s) for s in args.sizes.split(",")]:
      for mode in ("reference", "complementarity"):
        # "reference": the reference's exact termination semantics
        # (strict weak duality, explicit Jp+Jd gap).  "complementarity":
        # the production MPC certification (gap_from_complementarity,
        # strict off), far less razor-edge.
        gc = mode == "complementarity"
        M = max(8, N // 3)
        primal = gaussian_batch(N, M, args.b, seed=N)
        dual = dualize(primal)
        cfg = SolverConfig(max_iters=args.max_iters, check_every=16,
                           strict_weak_duality=not gc,
                           gap_from_complementarity=gc)
        mixed = jax.jit(lambda p, d: solve_mixed(p, d, cfg=cfg))
        engines = {"mixed": lambda: mixed(primal, dual)}
        if fused_supports(dual, cfg):
            engines["fused"] = lambda: solve_fused(primal, dual, cfg=cfg)
        t_x, rx = timed(lambda: solve_batched(primal, dual, cfg=cfg))
        ix, cx = np.asarray(rx.iters), np.asarray(rx.converged)
        row = {"bench": "engine_conformance",
               "device_kind": dev.device_kind, "N": N, "M": M,
               "B": args.b, "mode": mode, "xla_converged": int(cx.sum()),
               "xla_s": t_x}
        ok = True
        for name, fn in engines.items():
            t_e, re = timed(fn)
            ie, ce = np.asarray(re.iters), np.asarray(re.converged)
            both = cx & ce
            du = float(np.max(np.abs(np.asarray(re.U) - np.asarray(rx.U))
                              [:, both], initial=0.0))
            gap = abs(int(ce.sum()) - int(cx.sum()))
            row.update({
                f"{name}_converged": int(ce.sum()),
                f"{name}_iters_within_cadence": float(
                    (np.abs(ie.astype(np.int64) - ix)
                     <= cfg.check_every).mean()),
                f"{name}_max_dU": du, f"{name}_s": t_e})
            # verdict-count gaps pass within 10% of the batch, or in
            # reference mode when the f64 audit shows every disagreement
            # sits inside the f32 explicit-form noise floor
            conv_ok = gap <= PARITY_CONV_GAP_FRAC * args.b
            dis = ce != cx
            if mode == "reference" and dis.any():
                audit = f64_gap_audit(
                    primal, dual,
                    np.where(ce[None, :], np.asarray(re.Y),
                             np.asarray(rx.Y)), dis)
                row[f"{name}_disagree_audit"] = audit
                conv_ok = conv_ok or audit["below_floor_frac"] == 1.0
            ok = ok and conv_ok and du <= PARITY_U_ATOL
        row["parity_ok"] = ok
        ok_all = ok_all and ok
        print(json.dumps(row), flush=True)
    sys.exit(0 if ok_all else 1)


if __name__ == "__main__":
    main()
