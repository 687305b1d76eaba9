"""Command-line surface.

The reference's only "CLI" is five bare executables with no flags
(``./PQP_CPU`` etc., README.md:8-17) plus externally-timed benchmark
harnesses (``testing/*``, fixed 100 iterations at N=1000/M=500).  This
module exposes the same capabilities as subcommands of
``python -m pqp_for_mpc_tpu``:

* ``solve DIR``        — solve a reference ``example/``-format problem and
  print iterations / Jp / Jd / U* (mirrors main, PQP_CPU.c:1005-1013).
* ``solve-file FILE``  — solve a generator-format instance
  (``testing/test_generator.c`` layout).
* ``generate M N``     — emit a generator-format random instance
  (distributions of testing/test_generator.c:936-987).
* ``bench``            — the fixed-iteration throughput harness: k pure
  multiplicative updates, no convergence checks, mirroring the
  reference's ``while(h<NUM_ITER)`` timing loops
  (testing/CPU version/PQP_CPU_test.c:717).
* ``bench-example``    — full-convergence batched solves/s on the
  example-shaped stand-in problem on a GPU (same as bench.py).
* ``rollout``          — receding-horizon closed loop on a model-zoo
  plant (BASELINE config 4).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _build_solver_cfg(args, **overrides):
    from pqp_for_mpc_tpu.config import SolverConfig

    kw = dict(erc=args.erc, eac=args.eac, eaj=args.eaj, erj=args.erj,
              theta_floor=args.theta_floor, y0=args.y0,
              max_iters=args.max_iters, check_every=args.check_every,
              accel_every=args.accel_every,
              strict_weak_duality=not args.no_strict)
    kw.update(overrides)
    return SolverConfig(**kw)


def _add_solver_flags(p):
    p.add_argument("--erc", type=float, default=1e-6)
    p.add_argument("--eac", type=float, default=1e-6)
    p.add_argument("--eaj", type=float, default=1e-6)
    p.add_argument("--erj", type=float, default=1e-6)
    p.add_argument("--theta-floor", type=float, default=5.0)
    p.add_argument("--y0", type=float, default=1000.0,
                   help="cold-start value (reference: 1000; small values "
                        "like 0.01 converge far faster)")
    p.add_argument("--max-iters", type=int, default=200_000)
    p.add_argument("--check-every", type=int, default=8)
    p.add_argument("--accel-every", type=int, default=0,
                   help="projected-gradient acceleration cadence (0=off)")
    p.add_argument("--no-strict", action="store_true",
                   help="drop the reference's Jp<=-Jd termination quirk")


def cmd_solve(args) -> int:
    import jax.numpy as jnp
    from pqp_for_mpc_tpu.dual import dualize
    from pqp_for_mpc_tpu.io import load_example_dir
    from pqp_for_mpc_tpu.solver import solve

    data = load_example_dir(args.dir)
    cfg = _build_solver_cfg(args)
    t0 = time.perf_counter()
    primal = data.assemble(Qp=data.qp())
    dual = dualize(primal, theta_floor=cfg.theta_floor)
    res = solve(primal, dual, cfg=cfg)
    dt = time.perf_counter() - t0
    # output format mirrors the reference driver (PQP_CPU.c:741,1005-1013)
    print(f"Printing number of iterations = {int(res.iters)}")
    print(f"Jp = {float(res.Jp):.6f}")
    print(f"Jd = {float(res.Jd):.6f}")
    print("U*:")
    for v in np.asarray(res.U).ravel():
        print(f"  {v:.6f}")
    print(f"converged = {bool(res.converged)}  feasible = {bool(res.feasible)}"
          f"  wall = {dt:.3f}s (incl. compile)")
    return 0 if bool(res.converged) else 2


def cmd_solve_file(args) -> int:
    import jax.numpy as jnp
    from pqp_for_mpc_tpu.dual import dualize
    from pqp_for_mpc_tpu.io.generator import read_generator_file, to_primal_arrays
    from pqp_for_mpc_tpu.problem import PrimalQP
    from pqp_for_mpc_tpu.solver import solve

    inst = read_generator_file(args.file,
                               reference_quirks=args.reference_quirks)
    qp, qpi, fp, mp, gp, kp = to_primal_arrays(inst)
    primal = PrimalQP(Qp=jnp.asarray(qp), Qp_inv=jnp.asarray(qpi),
                      Fp=jnp.asarray(fp), Mp=jnp.asarray(mp),
                      Gp=jnp.asarray(gp), Kp=jnp.asarray(kp))
    cfg = _build_solver_cfg(args)
    dual = dualize(primal, theta_floor=cfg.theta_floor)
    engine = getattr(args, "engine", "auto")
    if getattr(args, "mixed", False):
        engine = "mixed"              # back-compat alias for --engine mixed
    t0 = time.perf_counter()
    if engine == "xla":
        res = solve(primal, dual, cfg=cfg)
        engine_used = "xla"
    else:
        import jax
        from functools import partial
        from pqp_for_mpc_tpu.routing import route_solve, solve_auto
        engine_used = (route_solve(dual.n_con, 1, False, cfg)
                       if engine == "auto" else engine)
        r = jax.jit(partial(solve_auto, cfg=cfg, engine=engine_used))(
            primal, dual)
        res = jax.tree.map(lambda a: a[..., 0] if a.ndim else a, r)
    dt = time.perf_counter() - t0
    print(f"M={inst.M} N={inst.N} iters={int(res.iters)} "
          f"converged={bool(res.converged)} feasible={bool(res.feasible)} "
          f"Jp={float(res.Jp):.6f} Jd={float(res.Jd):.6f} "
          f"engine={engine_used} wall={dt:.3f}s")
    return 0 if bool(res.converged) else 2


def cmd_generate(args) -> int:
    from pqp_for_mpc_tpu.io.generator import generate_instance, write_generator_file

    inst = generate_instance(args.M, args.N, seed=args.seed)
    write_generator_file(args.out, inst)
    print(f"wrote {args.out}: M={args.M} N={args.N} seed={args.seed}")
    return 0


def cmd_bench(args) -> int:
    """Fixed-iteration throughput: mirrors the reference testing/ harness
    (N=1000, M=500, 100 iterations, inert tolerances, no convergence
    checks inside the loop).  Reference wall times: CPU 4.651 s,
    GPU tiled 1.674 s (Report, 'Analysis')."""
    import jax
    import jax.numpy as jnp
    from pqp_for_mpc_tpu.dual import dualize
    from pqp_for_mpc_tpu.io.generator import generate_instance, to_primal_arrays
    from pqp_for_mpc_tpu.problem import PrimalQP
    from pqp_for_mpc_tpu.solver import pqp_update

    M, N, iters, B = args.M, args.N, args.iters, args.batch
    inst = generate_instance(M, N, seed=args.seed)
    qp, qpi, fp, mp, gp, kp = to_primal_arrays(inst)
    primal = PrimalQP(Qp=jnp.asarray(qp), Qp_inv=jnp.asarray(qpi),
                      Fp=jnp.asarray(fp), Mp=jnp.asarray(mp),
                      Gp=jnp.asarray(gp), Kp=jnp.asarray(kp))
    dual = dualize(primal, theta_floor=100.0)  # harness floor (…test.c:240)

    Y0 = jnp.full((N, B), 1000.0, jnp.float32)

    def body(_, Y):
        return pqp_update(dual, Y, None, 1e-30)
    run = jax.jit(lambda Y: jax.lax.fori_loop(0, iters, body, Y))

    jax.block_until_ready(run(Y0))          # compile
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run(Y0))
        times.append(time.perf_counter() - t0)
    dt = min(times)
    updates_per_s = iters * B / dt
    flops = 4.0 * N * N * B * iters         # two matvecs per update
    print(json.dumps({
        "metric": "pqp_iterations_per_s",
        "value": round(updates_per_s, 1),
        "unit": f"updates/s (M={M} N={N} B={B})",
        "seconds": round(dt, 4),
        "tflops": round(flops / dt / 1e12, 2),
        # the reference's tiled-GPU harness ran ONE instance of this
        # workload in 1.674 s wall (Report, 'Analysis'); we run B of them
        # in `seconds`, so the single-workload speedup is 1.674/seconds
        # and the throughput speedup is B times that.
        "reference_gpu_tiled_seconds": 1.674,
        "speedup_vs_reference_gpu": round(1.674 / dt, 1),
        "throughput_speedup_vs_reference_gpu": round(1.674 / dt * B, 1),
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }))
    return 0


def cmd_bench_example(args) -> int:
    # bench.py lives at the repo root, not in the package; load it by
    # path so this subcommand works from any cwd.
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "bench.py")
    if not os.path.exists(path):
        print("bench.py not found (installed package without the repo); "
              "use `bench` for the fixed-iteration harness", file=sys.stderr)
        return 1
    if root not in sys.path:
        sys.path.insert(0, root)       # bench.py imports chip_smoke
    spec = importlib.util.spec_from_file_location("_pqp_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main()


#: zoo entries constructible with no arguments (random_stable needs dims)
_ROLLOUT_PLANTS = ("double_integrator", "mass_spring_damper", "thermal_rc",
                   "dc_motor", "aircraft_pitch", "quadruple_tank")


def _csv_floats(s):
    return np.asarray([float(v) for v in s.split(",")], np.float32)


def cmd_rollout(args) -> int:
    from pqp_for_mpc_tpu.models import ZOO, MPCSpec, MPCController

    plant = ZOO[args.plant]()
    ny, nu = plant.n_output, plant.n_input
    y_bound = getattr(args, "y_max", None)
    spec = MPCSpec(
        plant=plant, horizon=args.horizon,
        Qy=np.eye(ny, dtype=np.float32),
        R=0.05 * np.eye(nu, dtype=np.float32),
        r=np.zeros(ny, np.float32),
        u_min=-np.ones(nu, np.float32), u_max=np.ones(nu, np.float32),
        du_max=0.5 * np.ones(nu, np.float32),
        y_min=None if y_bound is None
        else np.full(ny, -y_bound, np.float32),
        y_max=None if y_bound is None
        else np.full(ny, y_bound, np.float32),
        moves=getattr(args, "moves", None))
    robust_w = getattr(args, "robust_w", None)
    if robust_w is not None:
        # tube tightening: per-stage bound schedules from the box
        # supports of |w_i| <= robust_w_i (models/robust.py)
        from pqp_for_mpc_tpu.models import robust_spec
        w_box = _csv_floats(robust_w)
        if w_box.shape != (plant.n_state,):
            print(f"--robust-w needs {plant.n_state} comma-separated "
                  f"state-noise half-widths, got {w_box.shape[0]}",
                  file=sys.stderr)
            return 1
        spec = robust_spec(spec, w_box)
    backend = getattr(args, "backend", "auto")
    if backend == "auto":
        from pqp_for_mpc_tpu.models import auto_backend
        backend = auto_backend(spec)
    rng = np.random.default_rng(args.seed)
    x0 = rng.uniform(-1, 1, plant.n_state).astype(np.float32)
    t0 = time.perf_counter()
    offset_free = getattr(args, "offset_free", None)
    if offset_free is not None:
        # output-feedback offset-free loop: constant unmeasured
        # disturbance through the model channels, estimated + rejected
        from pqp_for_mpc_tpu.models import OffsetFreeController
        nd = nu if offset_free == "input" else ny
        d_true = (np.full(nd, 0.2, np.float32)
                  if getattr(args, "d_true", None) is None
                  else _csv_floats(args.d_true))
        ctrl = OffsetFreeController(
            spec, kind=offset_free, backend=backend,
            retry_cold=bool(getattr(args, "retry_cold", False)))
        ctrl.rollout_jit(x0, steps=args.steps, d_true=d_true)
        t0 = time.perf_counter()
        out = ctrl.rollout_jit(x0, steps=args.steps, d_true=d_true)
        out["converged"] = np.asarray(out["converged"])
        extra = {"offset_free": offset_free,
                 "d_true": d_true.tolist(),
                 "d_hat_final": np.asarray(out["d_hat"])[-1].tolist(),
                 "y_final": np.asarray(out["y"])[-1].tolist()}
    else:
        ctrl = MPCController(
            spec, backend=backend,
            warm_start="shift" if backend == "stagewise" else True,
            retry_cold=bool(getattr(args, "retry_cold", False)))
        if args.jit:
            ctrl.rollout_jit(x0, steps=args.steps)   # absorb compile
            t0 = time.perf_counter()
            out = ctrl.rollout_jit(x0, steps=args.steps)
        else:
            out = ctrl.rollout(x0, steps=args.steps)
        extra = {}
    dt = time.perf_counter() - t0
    print(json.dumps({
        "plant": args.plant, "horizon": args.horizon, "steps": args.steps,
        "backend": backend, "moves": getattr(args, "moves", None),
        "robust_w": robust_w,
        "final_state_norm": round(float(np.linalg.norm(out["x"][-1])), 4),
        "iters_mean": round(float(out["iters"].mean()), 1),
        "iters_max": int(out["iters"].max()),
        "wall_s": round(dt, 3),
        "steps_per_s": round(args.steps / dt, 1),
        **extra,
    }))
    return 0


def cmd_estimate(args) -> int:
    """State estimation over an input/measurement record: steady-state
    Kalman filter (``--kind kf``) or constrained moving-horizon
    estimation (``--kind mhe``, window ``--window``, optional noise
    bounds) on a model-zoo plant.  The record comes from ``--data
    FILE.npz`` (arrays ``U (T, nu)``, ``Y (T, ny)``, optional ``X``
    truth and ``x0``) or is synthesized with ``--simulate T`` (then the
    truth is known and an RMSE is reported).  ``-o OUT.npz`` writes the
    estimates.  The reference has no estimator at all — its state
    arrives by file (PQP_CPU.c:757-930)."""
    import jax.numpy as jnp
    from pqp_for_mpc_tpu.models import (ZOO, KalmanFilter,
                                        MovingHorizonEstimator)

    plant = ZOO[args.plant]()
    ns, nu, ny = plant.n_state, plant.n_input, plant.n_output
    qw = np.diag(np.full(ns, args.qw)).astype(np.float64)
    rv = np.diag(np.full(ny, args.rv)).astype(np.float64)

    X = None
    if args.data is not None:
        rec = np.load(args.data)
        U = np.asarray(rec["U"], np.float32).reshape(-1, nu)
        Y = np.asarray(rec["Y"], np.float32).reshape(-1, ny)
        X = np.asarray(rec["X"], np.float32) if "X" in rec else None
        x0 = (np.asarray(rec["x0"], np.float32) if "x0" in rec
              else np.zeros(ns, np.float32))
    else:
        T = args.simulate
        rng = np.random.default_rng(args.seed)
        A, B, C = (np.asarray(plant.A), np.asarray(plant.B),
                   np.asarray(plant.C))
        x = rng.uniform(-0.5, 0.5, ns).astype(np.float32)
        x0 = x.copy()
        U = (0.4 * np.sin(0.15 * np.arange(T))[:, None]
             * np.ones(nu)).astype(np.float32)
        X, Y = [], []
        for t in range(T):
            w = rng.normal(0, np.sqrt(args.qw), ns)
            if args.one_sided:
                w = np.abs(w)      # the bound a Gaussian filter can't see
            x = (A @ x + B @ U[t] + w).astype(np.float32)
            X.append(x.copy())
            Y.append((C @ x + rng.normal(0, np.sqrt(args.rv),
                                         ny)).astype(np.float32))
        X, Y = np.stack(X), np.stack(Y)

    T = Y.shape[0]
    if args.kind == "kf":
        kf = KalmanFilter(plant, qw, rv)
        xh = jnp.asarray(x0)
        est = []
        for t in range(T):
            xh = kf.step(xh, jnp.asarray(U[t]), jnp.asarray(Y[t]))
            est.append(np.asarray(xh))
        est = np.stack(est)
        iters_mean, conv = 0.0, 1.0
        est_for_rmse, truth = est, X
    else:
        kwargs = {}
        if args.one_sided:
            kwargs = dict(w_min=np.zeros(ns, np.float32))
        mhe = MovingHorizonEstimator(plant, args.window, qw, rv, **kwargs)
        out = mhe.run(x0, U, Y)
        est = out["x_hat"]
        iters_mean = float(out["iters"].mean())
        conv = float(out["converged"].mean())
        est_for_rmse = est
        truth = None if X is None else X[args.window - 1:]

    result = {"plant": args.plant, "kind": args.kind, "T": int(T),
              "estimates": int(est.shape[0]),
              "iters_mean": round(iters_mean, 1),
              "converged_frac": round(conv, 4)}
    if truth is not None:
        rmse = np.sqrt(((est_for_rmse - truth) ** 2).mean(axis=0))
        result["rmse"] = [round(float(v), 6) for v in rmse]
    if args.out:
        np.savez(args.out, x_hat=est)
        result["out"] = args.out
    print(json.dumps(result))
    return 0 if conv == 1.0 else 2


def _json_sanitize(obj):
    """Recursively replace non-finite floats with None so the reply is
    strict JSON (json.dumps would otherwise emit bare NaN/Infinity
    tokens that non-Python clients reject)."""
    import math
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_sanitize(v) for v in obj]
    return obj


def cmd_serve(args) -> int:
    """JSON-lines solver daemon: one request per stdin line, one result
    per stdout line.  Keeps the process (and its jit caches) alive so
    repeat solves of same-shaped problems skip compilation entirely.

    Request forms:
      {"example_dir": PATH, "x": [...]?, "batch_x": [[...], ...]?}
      {"generator_file": PATH}
      {"spec": {"plant": NAME, "horizon": H, "r"?, "u_min"?, "u_max"?,
                "du_max"?, "y_min"?, "y_max"?},
       "x": [...], "u_prev": [...]?}     — one MPC step; reply carries
                                           "u0" (controller caches per
                                           spec for the daemon's life)
      {"cmd": "quit"}
    Reply: the solve stats dict plus the solution —
      {"batch": n, "converged": n_ok, "feasible": n_feas,
       "iters_mean": ..., "iters_max": ..., "gap_abs_max": ...,
       "gap_rel_max": ..., "U": [[...] per instance]}
    or {"error": "..."}.  Problem geometry (and its jit caches) is kept
    per example_dir for the life of the daemon — files changed on disk
    after first load are NOT re-read.
    """
    import jax.numpy as jnp
    from pqp_for_mpc_tpu.dual import dual_geometry, dualize_forcing
    from pqp_for_mpc_tpu.io import load_example_dir
    from pqp_for_mpc_tpu.io.generator import (read_generator_file,
                                              to_primal_arrays)
    from pqp_for_mpc_tpu.problem import PrimalQP
    from pqp_for_mpc_tpu.solver import solve_batched

    cfg = _build_solver_cfg(args)
    cache: dict = {}

    def solve_example(req):
        path = req["example_dir"]
        entry = cache.get(path)
        if entry is None:
            data = load_example_dir(path)
            Qp = data.qp()
            geom = dual_geometry(data.Gp, data.Qp_inv,
                                 theta_floor=cfg.theta_floor,
                                 precision=cfg.precision)
            entry = cache[path] = (data, Qp, geom)
        data, Qp, geom = entry
        if "batch_x" in req:
            x = jnp.asarray(np.asarray(req["batch_x"], np.float32).T)
        elif "x" in req:
            x = jnp.asarray(np.asarray(req["x"], np.float32))
        else:
            x = None
        primal = data.assemble(x=x, Qp=Qp)
        dual = dualize_forcing(geom, primal.Fp, primal.Mp, primal.Kp,
                               precision=cfg.precision)
        return solve_batched(primal, dual, cfg=cfg)

    def solve_generator(req):
        inst = read_generator_file(req["generator_file"])
        qp, qpi, fp, mp, gp, kp = to_primal_arrays(inst)
        primal = PrimalQP(Qp=jnp.asarray(qp), Qp_inv=jnp.asarray(qpi),
                          Fp=jnp.asarray(fp), Mp=jnp.asarray(mp),
                          Gp=jnp.asarray(gp), Kp=jnp.asarray(kp))
        from pqp_for_mpc_tpu.dual import dualize
        dual = dualize(primal, theta_floor=cfg.theta_floor,
                       precision=cfg.precision)
        return solve_batched(primal, dual, cfg=cfg)

    def solve_spec(req):
        """Spec-based MPC step: build (and cache) a controller from a
        JSON spec, solve one step from the given state."""
        from pqp_for_mpc_tpu.models import ZOO, MPCSpec, MPCController
        s = req["spec"]
        key = ("spec", json.dumps(s, sort_keys=True))
        ctrl = cache.get(key)
        if ctrl is None:
            plant = ZOO[s["plant"]]()
            ny, nu = plant.n_output, plant.n_input
            arr = lambda k, default: (
                np.asarray(s[k], np.float32) if k in s else default)
            spec = MPCSpec(
                plant=plant, horizon=int(s["horizon"]),
                Qy=arr("Qy", np.eye(ny, dtype=np.float32)),
                R=arr("R", 0.05 * np.eye(nu, dtype=np.float32)),
                r=arr("r", np.zeros(ny, np.float32)),
                u_min=arr("u_min", -np.ones(nu, np.float32)),
                u_max=arr("u_max", np.ones(nu, np.float32)),
                du_max=arr("du_max", np.full(nu, 0.5, np.float32)),
                y_min=arr("y_min", None), y_max=arr("y_max", None))
            ctrl = cache[key] = MPCController(spec, backend="auto",
                                              warm_start=False)
        x = np.asarray(req["x"], np.float32)
        u_prev = (np.asarray(req["u_prev"], np.float32)
                  if "u_prev" in req else None)
        u0, res = ctrl.step(jnp.asarray(x), u_prev=u_prev)
        u0 = np.asarray(u0)
        return (u0[:, 0] if u0.ndim == 2 else u0), res

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if req.get("cmd") == "quit":
                break
            u0 = None
            if "example_dir" in req:
                res = solve_example(req)
            elif "generator_file" in req:
                res = solve_generator(req)
            elif "spec" in req:
                u0, res = solve_spec(req)
            else:
                raise ValueError("request needs example_dir, "
                                 "generator_file, or spec")
            out = res.stats()
            if u0 is not None:
                out["u0"] = u0.tolist()
            out["U"] = np.asarray(res.U).T.tolist()
            out["diverged"] = int(np.asarray(res.diverged).sum())
            # strict JSON has no NaN/Infinity tokens; a diverged solve
            # would otherwise break every non-Python client of the
            # JSON-lines protocol — map non-finite floats to null.
            reply = json.dumps(_json_sanitize(out), allow_nan=False)
        except Exception as e:     # noqa: BLE001 — daemon must not die
            reply = json.dumps({"error": f"{type(e).__name__}: {e}"})
        try:
            print(reply, flush=True)
        except (BrokenPipeError, OSError):
            break                  # client hung up — clean shutdown
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pqp_for_mpc_tpu",
        description="Batched PQP engine for linear MPC")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("solve", help="solve a reference example/-format dir")
    p.add_argument("dir")
    _add_solver_flags(p)
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("solve-file", help="solve a generator-format file")
    p.add_argument("file")
    p.add_argument("--reference-quirks", action="store_true",
                   help="reproduce the reference harness reader's quirks "
                        "(random Kp overwrite; -1 entries flipped to 1)")
    p.add_argument("--mixed", action="store_true",
                   help="alias for --engine mixed (bf16 bulk phase + "
                        "f32 certification; wins for large N)")
    p.add_argument("--engine", default="auto",
                   choices=("auto", "xla", "fused", "mixed"),
                   help="solve engine; auto = the measured regime map "
                        "(routing.route_solve)")
    _add_solver_flags(p)
    p.set_defaults(fn=cmd_solve_file)

    p = sub.add_parser("generate", help="emit a random generator-format instance")
    p.add_argument("M", type=int)
    p.add_argument("N", type=int)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--out", default="test.txt")
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser("bench", help="fixed-iteration throughput harness")
    p.add_argument("--M", type=int, default=500)
    p.add_argument("--N", type=int, default=1000)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repeats", type=int, default=3)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("bench-example", help="full-convergence solves/s "
                                             "on one GPU (bench.py)")
    p.set_defaults(fn=cmd_bench_example)

    p = sub.add_parser("rollout", help="receding-horizon closed loop")
    p.add_argument("--plant", default="double_integrator",
                   choices=_ROLLOUT_PLANTS)
    p.add_argument("--horizon", type=int, default=16)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", choices=("auto", "condensed", "stagewise"),
                   default="auto",
                   help="condensed = dense dual (the reference's "
                        "formulation); stagewise = matrix-free O(H) "
                        "path for long horizons (tolerances auto-set "
                        "to the horizon's float32 certification floor); "
                        "auto = pick by the measured n_con crossover "
                        "(models.auto_backend)")
    p.add_argument("--retry-cold", action="store_true",
                   help="certify-or-recover: re-solve any step whose "
                        "warm start fails certification from the cold "
                        "start (one in-graph retry; a single compiled "
                        "solve instance, any horizon)")
    p.add_argument("--jit", action="store_true",
                   help="run the whole closed loop as one lax.scan "
                        "dispatch (no per-step host round-trips)")
    p.add_argument("--y-max", type=float, default=None,
                   help="symmetric output (state) bound |y| <= Y_MAX "
                        "— hard constraint rows on either backend")
    p.add_argument("--moves", type=int, default=None,
                   help="move blocking (condensed backend): hold the "
                        "input constant over MOVES blocks spread over "
                        "the horizon — the dual shrinks from 4*H*nu to "
                        "4*MOVES*nu rows")
    p.add_argument("--robust-w", default=None, metavar="W1,W2,...",
                   help="robust tube tightening for additive state "
                        "disturbances |w_i| <= W_i (one half-width per "
                        "state): bounds become per-stage schedules that "
                        "keep the ORIGINAL bounds under any admissible "
                        "disturbance (models/robust.py)")
    p.add_argument("--offset-free", choices=("input", "output"),
                   default=None,
                   help="run the output-feedback offset-free loop "
                        "(augmented-KF estimation + steady-state "
                        "targets + deviation MPC) against a constant "
                        "unmeasured disturbance --d-true")
    p.add_argument("--d-true", default=None, metavar="D1,...",
                   help="true unmeasured disturbance for --offset-free "
                        "(default 0.2 per channel)")
    p.set_defaults(fn=cmd_rollout)

    p = sub.add_parser("estimate", help="state estimation (KF / "
                                        "constrained MHE) over a record")
    p.add_argument("--plant", default="double_integrator",
                   choices=_ROLLOUT_PLANTS)
    p.add_argument("--kind", choices=("kf", "mhe"), default="mhe")
    p.add_argument("--window", type=int, default=10,
                   help="MHE window length")
    p.add_argument("--data", default=None,
                   help="npz record with U (T, nu), Y (T, ny) "
                        "[, X truth, x0]; omit to --simulate")
    p.add_argument("--simulate", type=int, default=120, metavar="T",
                   help="synthesize a T-step noisy record (truth known "
                        "-> RMSE reported)")
    p.add_argument("--one-sided", action="store_true",
                   help="one-sided process noise (w >= 0): the regime "
                        "where the bounded MHE beats any Kalman filter")
    p.add_argument("--qw", type=float, default=1e-4,
                   help="process-noise variance (per state)")
    p.add_argument("--rv", type=float, default=1e-4,
                   help="measurement-noise variance (per output)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--out", default=None,
                   help="write x_hat to this npz")
    p.set_defaults(fn=cmd_estimate)

    p = sub.add_parser("serve", help="JSON-lines solver daemon on stdio")
    _add_solver_flags(p)
    p.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    from pqp_for_mpc_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
