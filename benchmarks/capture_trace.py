"""Capture a jax.profiler trace of one headline-workload solve on a GPU.

Solves a batch of the example-shaped stand-in problem (N=28,
models.example) through ``solve_auto`` to the reference tolerances once
to warm up, then once inside :func:`pqp_for_mpc_tpu.utils.profiling.trace`,
and prints the eight device events with the largest total duration.

Run: ``python benchmarks/capture_trace.py [--logdir .build/trace]
[--batch 262144]``, then load the ``*.trace.json.gz`` in
ui.perfetto.dev.
"""

import argparse
import glob
import gzip
import json
import os
import sys
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--logdir", default=".build/trace")
    ap.add_argument("--batch", type=int, default=1 << 18)
    args = ap.parse_args()

    import jax

    from chip_smoke import SCENARIO_CFG
    from pqp_for_mpc_tpu import SolverConfig, dualize, solve_auto
    from pqp_for_mpc_tpu.models.example import example_problem
    from pqp_for_mpc_tpu.utils.profiling import trace

    if jax.devices()[0].platform != "gpu":
        sys.exit("capture_trace.py: no GPU")
    cfg = SolverConfig(**SCENARIO_CFG)
    primal = example_problem(args.batch, seed=0)
    dual = dualize(primal, theta_floor=cfg.theta_floor)
    solve = jax.jit(lambda p, d: solve_auto(p, d, cfg=cfg))
    jax.block_until_ready(solve(primal, dual))       # compile + warm
    with trace(args.logdir):
        res = jax.block_until_ready(solve(primal, dual))
    print("converged:", int(np.asarray(res.converged).sum()), "/",
          args.batch, " mean iters:", float(np.asarray(res.iters).mean()))

    runs = sorted(glob.glob(os.path.join(args.logdir, "plugins/profile/*")))
    latest = runs[-1]
    tj = glob.glob(os.path.join(latest, "*.trace.json.gz"))[0]
    events = json.load(gzip.open(tj)).get("traceEvents", [])
    dur = defaultdict(float)
    cnt = defaultdict(int)
    for e in events:
        if e.get("ph") == "X":
            dur[e["name"]] += e.get("dur", 0)
            cnt[e["name"]] += 1
    print(f"trace run: {latest}")
    for k in sorted(dur, key=lambda k: -dur[k])[:8]:
        print(f"  {dur[k] / 1e3:10.3f} ms  x{cnt[k]:4d}  {k[:80]}")


if __name__ == "__main__":
    main()
