"""Run the PQP engine's main path once on one NVIDIA GPU and check it.

    python chip_smoke.py [--seed S]      # one GPU, every phase
    python chip_smoke.py --four          # four GPUs, the multi-card paths only

Phases (one JSON line each, then the device line, then the result):

1. device      - device kind and count, the card's name and power limit
                 (``nvidia-smi``), the JAX version and ``XLA_FLAGS``.
2. scenario    - 1,048,576 example-shaped QPs (N=28, M=7) through
                 ``solve_auto`` at the reference tolerances; 256 lanes
                 checked against the C++ float32 oracle.
3. kernel      - the whole-solve GPU kernel against ``solve_batched`` at
                 N=28 (the phase-2 shape) and N=64/128 (B=262,144):
                 parity and the best-of-5 wall time of each engine
                 (N=128 is beyond the kernel: XLA only).
4. closed_loop - ``MPCController.rollout_jit`` for 50 steps: condensed
                 mass-spring-damper at H=32 and stage-wise double
                 integrator at H=512.
5. large_n     - a dense random N=4096, B=128 problem (``Qd`` is 67 MB)
                 through ``solve_batched`` and ``solve_mixed``.
6. serve       - three JSON-lines requests through ``cli serve``,
                 in this process.

Any failed check raises, and the script exits non-zero.  It exits
non-zero at once when JAX finds no GPU.  Everything runs in this one
process: a second JAX process could not reserve the card's memory.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))

#: phase-2 certificate: the reference tolerances (1e-6) with the
#: complementarity gap and no strict weak-duality test — with the
#: reference's explicit-gap test these tolerances sit at f32 rounding
#: noise, and which lanes certify then depends on summation order
SCENARIO_CFG = dict(max_iters=5000, check_every=8, y0=1000.0,
                    precision="highest", strict_weak_duality=False,
                    gap_from_complementarity=True)
LARGE_N_CFG = dict(max_iters=30000, check_every=16, accel_every=16,
                   precision="highest", strict_weak_duality=False,
                   gap_from_complementarity=True)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def compile_and_time(fn, args, reps: int = 1):
    """AOT-compile ``jit(fn)`` for ``args``, run it ``reps`` times to
    completion.  Returns (result, compile_s, best_run_s)."""
    import jax
    from pqp_for_mpc_tpu.utils.profiling import timed
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    best, out = timed(lambda: compiled(*args), repeats=reps, warmup=0)
    return out, compile_s, best


def max_rel_dU(Ua, Ub, lanes) -> float:
    """max |Ua - Ub| over ``lanes``, scaled by max(1, |Ua|_inf)."""
    Ua, Ub = np.asarray(Ua)[:, lanes], np.asarray(Ub)[:, lanes]
    if Ua.size == 0:
        return 0.0
    return float(np.abs(Ua - Ub).max() / max(1.0, np.abs(Ua).max()))


def nvidia_smi() -> str:
    """The card's name and power limit, read by ``nvidia-smi`` in a
    child process that does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def phase_device() -> str:
    import jax
    d = jax.devices()[0]
    smi = nvidia_smi()
    emit("device", platform=d.platform, kind=d.device_kind,
         count=len(jax.devices()), nvidia_smi=smi,
         jax_version=jax.__version__,
         xla_flags=os.environ.get("XLA_FLAGS", ""))
    return smi


def phase_scenario(batch: int = 1 << 20, seed: int = 0,
                   oracle_lanes: int = 256) -> None:
    from pqp_for_mpc_tpu import SolverConfig, dualize, native
    from pqp_for_mpc_tpu.models.example import example_problem
    from pqp_for_mpc_tpu.routing import route_solve, solve_auto

    cfg = SolverConfig(**SCENARIO_CFG)
    primal = example_problem(batch, seed)
    dual = dualize(primal, theta_floor=cfg.theta_floor)
    N, M = dual.n_con, primal.Gp.shape[1]
    res, compile_s, run_s = compile_and_time(
        lambda p, d: solve_auto(p, d, cfg=cfg), (primal, dual), reps=3)
    conv = np.asarray(res.converged)
    iters = np.asarray(res.iters)

    lanes = np.linspace(0, batch - 1, min(oracle_lanes, batch)).astype(int)
    Fp, Mp = np.asarray(primal.Fp), np.asarray(primal.Mp)
    ora = [native.oracle_solve(
        np.asarray(primal.Qp_inv), Fp[:, i], Mp[i], np.asarray(primal.Gp),
        np.asarray(primal.Kp), max_iters=cfg.max_iters, y0=cfg.y0,
        theta_floor=cfg.theta_floor, strict=cfg.strict_weak_duality,
        gap_comp=cfg.gap_from_complementarity) for i in lanes]
    o_conv = np.array([o["converged"] for o in ora])
    o_U = np.stack([o["U"] for o in ora], axis=1)
    both = o_conv & conv[lanes]
    dU = max_rel_dU(o_U, np.asarray(res.U)[:, lanes], np.nonzero(both)[0])
    flags_agree = bool(np.array_equal(o_conv, conv[lanes]))
    emit("scenario", N=N, M=M, batch=batch, seed=seed,
         engine=route_solve(N, batch, False, cfg),
         certified_frac=float(conv.mean()),
         iters_mean=float(iters.mean()), iters_max=int(iters.max()),
         compile_s=compile_s, run_s=run_s, solves_per_s=batch / run_s,
         oracle_lanes=len(lanes), oracle_flags_agree=flags_agree,
         oracle_certified=int(o_conv.sum()), oracle_max_rel_dU=dU)
    check(flags_agree, "certified flags differ from the C++ oracle")
    check(dU <= 1e-3, f"U differs from the C++ oracle by {dU:.3g}")


def phase_kernel(shapes=((29, 7, 1 << 20), (29, 16, 1 << 18),
                         (32, 32, 1 << 18)),
                 seed: int = 0, reps: int = 5,
                 interpret: bool = False) -> None:
    """Whole-solve kernel against solve_batched.  ``shapes`` are
    (rooms, heaters, batch) of the thermal example: N = 4*heaters.
    Where the kernel does not take N (``fused_supports``), only the
    XLA engine runs."""
    from pqp_for_mpc_tpu import SolverConfig, dualize, solve_batched
    from pqp_for_mpc_tpu.models.example import example_problem
    from pqp_for_mpc_tpu.ops.solve_kernel import fused_supports, solve_fused

    cfg = SolverConfig(**SCENARIO_CFG)
    for rooms, heaters, batch in shapes:
        primal = example_problem(batch, seed, n_rooms=rooms,
                                 n_heaters=heaters)
        dual = dualize(primal, theta_floor=cfg.theta_floor)
        rx, cx, tx = compile_and_time(
            lambda p, d: solve_batched(p, d, cfg=cfg), (primal, dual),
            reps=reps)
        conv = np.asarray(rx.converged)
        row = dict(N=dual.n_con, M=primal.Gp.shape[1], batch=batch,
                   certified_frac=float(conv.mean()),
                   iters_mean=float(np.asarray(rx.iters).mean()),
                   xla_compile_s=cx, xla_best_s=tx)
        if not fused_supports(dual, cfg):
            emit("kernel", **row, fused="not supported at this N")
            continue
        rf, cf, tf = compile_and_time(
            lambda p, d: solve_fused(p, d, cfg=cfg, interpret=interpret),
            (primal, dual), reps=reps)
        same_set = bool(np.array_equal(conv, np.asarray(rf.converged)))
        d_it = int(np.abs(np.asarray(rx.iters) - np.asarray(rf.iters)).max())
        dU = max_rel_dU(rx.U, rf.U, np.nonzero(conv)[0])
        emit("kernel", **row, same_certified_set=same_set, max_rel_dU=dU,
             max_iters_diff=d_it, fused_compile_s=cf, fused_best_s=tf,
             fused_speedup=tx / tf)
        check(same_set, "kernel certified a different lane set")
        check(dU <= 1e-3, f"kernel U differs by {dU:.3g}")
        check(d_it <= cfg.check_every, f"kernel iterations differ by {d_it}")


def _closed_loop_specs():
    from pqp_for_mpc_tpu.models import (MPCSpec, double_integrator,
                                        mass_spring_damper)
    msd = mass_spring_damper()
    nu, ny = msd.n_input, msd.n_output
    condensed = MPCSpec(
        plant=msd, horizon=32, Qy=np.eye(ny, dtype=np.float32),
        R=0.05 * np.eye(nu, dtype=np.float32), r=np.zeros(ny, np.float32),
        u_min=-np.ones(nu, np.float32), u_max=np.ones(nu, np.float32),
        du_max=np.full(nu, 0.5, np.float32))
    x_msd = np.zeros(msd.n_state, np.float32)
    x_msd[:msd.n_output] = 1.0
    # examples/long_horizon_mpc.py
    stagewise = MPCSpec(
        plant=double_integrator(), horizon=512,
        Qy=np.eye(1, dtype=np.float32),
        R=0.05 * np.eye(1, dtype=np.float32), r=np.zeros(1, np.float32),
        u_min=np.array([-1.0], np.float32),
        u_max=np.array([1.0], np.float32),
        du_max=np.array([0.5], np.float32))
    return [("condensed", condensed, x_msd),
            ("stagewise", stagewise, np.array([2.0, 0.0], np.float32))]


def phase_closed_loop(steps: int = 50, horizons=None) -> None:
    import dataclasses
    from pqp_for_mpc_tpu.models import MPCController

    for backend, spec, x0 in _closed_loop_specs():
        if horizons:
            spec = dataclasses.replace(spec, horizon=horizons[backend])
        t0 = time.perf_counter()
        ctrl = MPCController(spec, backend=backend, warm_start="shift",
                             retry_cold=True)
        u0, first = ctrl.step(x0)
        np.asarray(u0)
        first_s = time.perf_counter() - t0
        first_from_start_s = time.perf_counter() - _T_START
        ctrl.reset()
        t0 = time.perf_counter()
        ctrl.rollout_jit(x0, steps=steps)
        compile_run_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = ctrl.rollout_jit(x0, steps=steps)
        run_s = time.perf_counter() - t0
        finite = bool(np.isfinite(out["x"]).all()
                      and np.isfinite(out["u"]).all())
        emit("closed_loop", backend=backend, plant=spec.plant.name,
             horizon=spec.horizon, steps=steps,
             certified_frac=float(out["converged"].mean()),
             iters_mean=float(out["iters"].mean()), finite=finite,
             first_step_s=first_s,
             first_step_from_process_start_s=first_from_start_s,
             compile_and_run_s=compile_run_s, run_s=run_s,
             steps_per_s=steps / run_s)
        check(bool(out["converged"].all()), f"{backend}: uncertified steps")
        check(finite, f"{backend}: non-finite trajectory")


def phase_large_n(N: int = 4096, M: int = 1024, B: int = 128,
                  seed: int = 0) -> None:
    from pqp_for_mpc_tpu import SolverConfig, dualize, solve_batched
    from pqp_for_mpc_tpu.io.generator import gaussian_batch
    from pqp_for_mpc_tpu.solver import solve_mixed

    cfg = SolverConfig(**LARGE_N_CFG)
    primal = gaussian_batch(N, M, B, seed)
    dual = dualize(primal, theta_floor=cfg.theta_floor,
                   materialize_splits=False)
    out = {}
    for name, fn in (("f32", solve_batched), ("mixed", solve_mixed)):
        out[name] = compile_and_time(
            lambda p, d, fn=fn: fn(p, d, cfg=cfg), (primal, dual))
    (r32, c32, t32), (rmx, cmx, tmx) = out["f32"], out["mixed"]
    n32 = int(np.asarray(r32.converged).sum())
    nmx = int(np.asarray(rmx.converged).sum())
    both = np.asarray(r32.converged) & np.asarray(rmx.converged)
    dU = max_rel_dU(r32.U, rmx.U, np.nonzero(both)[0])
    emit("large_n", N=N, M=M, batch=B, qd_bytes=N * N * 4,
         f32_certified=n32, mixed_certified=nmx, max_rel_dU=dU,
         f32_iters_mean=float(np.asarray(r32.iters).mean()),
         mixed_iters_mean=float(np.asarray(rmx.iters).mean()),
         f32_compile_s=c32, mixed_compile_s=cmx, f32_s=t32, mixed_s=tmx)
    check(n32 == nmx, f"certified counts differ: f32 {n32}, mixed {nmx}")
    check(dU <= 1e-3, f"mixed U differs by {dU:.3g}")


def phase_serve(gen_dims=(64, 256)) -> None:
    from pqp_for_mpc_tpu import cli
    from pqp_for_mpc_tpu.io.generator import (generate_instance,
                                              write_generator_file)

    work = os.path.join(ROOT, ".build")
    os.makedirs(work, exist_ok=True)
    gen_path = os.path.join(work, "serve_generated.txt")
    write_generator_file(gen_path, generate_instance(*gen_dims, seed=0))
    spec = {"plant": "double_integrator", "horizon": 16}
    requests = [{"spec": spec, "x": [1.0, 0.0]},
                {"spec": spec, "x": [0.5, -0.2]},
                {"generator_file": gen_path}]
    stdin = io.StringIO("".join(json.dumps(r) + "\n" for r in requests))
    stdout = io.StringIO()
    old = sys.stdin, sys.stdout
    sys.stdin, sys.stdout = stdin, stdout
    t0 = time.perf_counter()
    try:
        rc = cli.main(["serve", "--max-iters", "20000"])
    finally:
        sys.stdin, sys.stdout = old
    wall = time.perf_counter() - t0
    replies = [json.loads(s) for s in stdout.getvalue().splitlines()]
    errors = [r["error"] for r in replies if "error" in r]
    emit("serve", requests=len(requests), replies=len(replies), rc=rc,
         errors=errors, wall_s=wall,
         converged=[r.get("converged") for r in replies])
    check(rc == 0 and len(replies) == len(requests) and not errors,
          f"serve failed: rc={rc}, {len(replies)} replies, {errors}")


def phase_four(seed: int = 0, n_dev: int = 4, batch_per_card: int = 1 << 18,
               N: int = 4096, M: int = 1024, B: int = 128) -> None:
    """The two paths across ``n_dev`` cards, each against one device."""
    import jax
    from pqp_for_mpc_tpu import SolverConfig, dualize, solve_batched
    from pqp_for_mpc_tpu.io.generator import gaussian_batch
    from pqp_for_mpc_tpu.models.example import example_problem
    from pqp_for_mpc_tpu.parallel.mesh import make_mesh
    from pqp_for_mpc_tpu.parallel.sharded import (shard_batch,
                                                  solve_row_sharded)

    cards = jax.devices()[:n_dev]
    devices = lambda a: sorted(str(d) for d in a.sharding.device_set)

    cfg = SolverConfig(**SCENARIO_CFG)
    primal = example_problem(n_dev * batch_per_card, seed)
    dual = dualize(primal, theta_floor=cfg.theta_floor)
    one, _, t_one = compile_and_time(
        lambda p, d: solve_batched(p, d, cfg=cfg), (primal, dual))
    p_s, d_s = shard_batch(primal, dual,
                           make_mesh(data=n_dev, model=1, devices=cards))
    dp, _, t_dp = compile_and_time(
        lambda p, d: solve_batched(p, d, cfg=cfg), (p_s, d_s))
    same = bool(np.array_equal(np.asarray(one.converged),
                               np.asarray(dp.converged))
                and np.array_equal(np.asarray(one.iters),
                                   np.asarray(dp.iters)))
    dU = max_rel_dU(one.U, dp.U, np.nonzero(np.asarray(one.converged))[0])
    emit("four_data_parallel", batch=int(primal.Fp.shape[1]),
         fp_devices=devices(p_s.Fp), u_devices=devices(dp.U),
         same_flags_and_iters=same, max_rel_dU=dU,
         one_device_s=t_one, sharded_s=t_dp)
    check(len(set(devices(dp.U))) == n_dev, "batch not spread over cards")
    check(same and dU <= 1e-3, "data-parallel lanes differ from one device")

    cfg_l = SolverConfig(**LARGE_N_CFG)
    primal = gaussian_batch(N, M, B, seed)
    dual = dualize(primal, theta_floor=cfg_l.theta_floor)
    mesh = make_mesh(data=1, model=n_dev, devices=cards)
    ref, _, t_ref = compile_and_time(
        lambda p, d: solve_batched(p, d, cfg=cfg_l), (primal, dual))
    for mixed in (False, True):
        res, _, t_rs = compile_and_time(
            lambda p, d, mixed=mixed: solve_row_sharded(
                p, d, cfg=cfg_l, mesh=mesh, mixed=mixed), (primal, dual))
        n_ref = int(np.asarray(ref.converged).sum())
        n_rs = int(np.asarray(res.converged).sum())
        both = np.asarray(ref.converged) & np.asarray(res.converged)
        dU = max_rel_dU(ref.U, res.U, np.nonzero(both)[0])
        emit("four_row_sharded", N=N, batch=B, mixed=mixed,
             y_devices=devices(res.Y), replicated_certified=n_ref,
             sharded_certified=n_rs, max_rel_dU=dU,
             replicated_s=t_ref, sharded_s=t_rs)
        check(n_ref == n_rs and dU <= 1e-3,
              f"row-sharded (mixed={mixed}) differs from replicated")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-card paths, on four GPUs")
    args = ap.parse_args(argv)

    import jax
    from pqp_for_mpc_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform})",
              file=sys.stderr)
        return 1
    need = 4 if args.four else 1
    if len(devs) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 1

    smi = phase_device()
    if args.four:
        phase_four(args.seed, n_dev=need)
    else:
        phase_scenario(seed=args.seed)
        phase_kernel(seed=args.seed)
        phase_closed_loop()
        phase_large_n(seed=args.seed)
        phase_serve()
    print(smi)
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
