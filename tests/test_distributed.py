"""Multi-process distributed smoke test on a CPU ring.

Spawns two fresh processes (each with 4 virtual CPU devices), forms a
jax.distributed cluster, builds the global (8, 1) mesh, runs the
data-parallel batched solve on per-process shards and checks both ranks
agree with the single-process result — the closest this environment gets
to multi-host validation (SURVEY.md §5.8).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
rank = int(sys.argv[1]); port = sys.argv[2]; out = sys.argv[3]
import pqp_for_mpc_tpu.parallel.distributed as dist
dist.initialize(coordinator_address=f"localhost:{port}",
                num_processes=2, process_id=rank, local_device_count=4)
import jax, numpy as np, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from pqp_for_mpc_tpu import SolverConfig, dualize, solve_batched
from pqp_for_mpc_tpu.problem import PrimalQP
from pqp_for_mpc_tpu.parallel.distributed import (global_mesh,
                                                  process_local_batch_slice)

assert jax.process_count() == 2 and jax.device_count() == 8

B, M, N = 16, 8, 20
rng = np.random.default_rng(0)           # same instance on both ranks
L = rng.standard_normal((M, M)).astype(np.float32)
Qp = L @ L.T + M * np.eye(M, dtype=np.float32)
Qp_inv = np.linalg.inv(Qp).astype(np.float32)
Gp = rng.integers(-1, 2, (N, M)).astype(np.float32)
Kp = rng.uniform(1.0, 10.0, N).astype(np.float32)
Fp = rng.standard_normal((M, B)).astype(np.float32) * 5
Mp = rng.standard_normal(B).astype(np.float32)

mesh = global_mesh(model=1)
col = NamedSharding(mesh, P(None, "data"))
vec = NamedSharding(mesh, P("data"))
rep = NamedSharding(mesh, P())
sl = process_local_batch_slice(B)
Fp_g = jax.make_array_from_process_local_data(col, Fp[:, sl])
Mp_g = jax.make_array_from_process_local_data(vec, Mp[sl])
dev = lambda a: jax.device_put(jnp.asarray(a), rep)
primal = PrimalQP(Qp=dev(Qp), Qp_inv=dev(Qp_inv), Fp=Fp_g, Mp=Mp_g,
                  Gp=dev(Gp), Kp=dev(Kp))
dual = dualize(primal)
cfg = SolverConfig(max_iters=20_000, check_every=4)
res = solve_batched(primal, dual, cfg=cfg)
from jax.experimental import multihost_utils as mhu
U_bt = np.asarray(mhu.process_allgather(res.U.T, tiled=True))   # (B, M)
iters = np.asarray(mhu.process_allgather(res.iters, tiled=True))
np.savez(out, U=U_bt, iters=iters)
print("RANK", rank, "OK")
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@pytest.mark.slow
def test_two_process_data_parallel(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("JAX_COMPILATION_CACHE_DIR",
                   os.path.join(REPO, ".jax_cache"))
    procs = []
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    for r in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), str(port), outs[r]],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        logs.append(out.decode(errors="replace"))
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
        assert f"RANK {r} OK" in log

    # both ranks computed; compare against single-process reference
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from pqp_for_mpc_tpu import SolverConfig, dualize, solve_batched
    from pqp_for_mpc_tpu.problem import PrimalQP

    B, M, N = 16, 8, 20
    rng = np.random.default_rng(0)
    L = rng.standard_normal((M, M)).astype(np.float32)
    Qp = L @ L.T + M * np.eye(M, dtype=np.float32)
    Qp_inv = np.linalg.inv(Qp).astype(np.float32)
    Gp = rng.integers(-1, 2, (N, M)).astype(np.float32)
    Kp = rng.uniform(1.0, 10.0, N).astype(np.float32)
    Fp = rng.standard_normal((M, B)).astype(np.float32) * 5
    Mp = rng.standard_normal(B).astype(np.float32)
    primal = PrimalQP(Qp=jnp.asarray(Qp), Qp_inv=jnp.asarray(Qp_inv),
                      Fp=jnp.asarray(Fp), Mp=jnp.asarray(Mp),
                      Gp=jnp.asarray(Gp), Kp=jnp.asarray(Kp))
    ref = solve_batched(primal, dualize(primal),
                        cfg=SolverConfig(max_iters=20_000, check_every=4))

    for out in outs:
        z = np.load(out)
        np.testing.assert_allclose(z["U"].T, np.asarray(ref.U),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(z["iters"], np.asarray(ref.iters))


WORKER_MODEL = r"""
import os, sys
rank = int(sys.argv[1]); port = sys.argv[2]; out = sys.argv[3]
import pqp_for_mpc_tpu.parallel.distributed as dist
dist.initialize(coordinator_address=f"localhost:{port}",
                num_processes=2, process_id=rank, local_device_count=4)
import jax, numpy as np, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from pqp_for_mpc_tpu import SolverConfig, dualize, solve_batched
from pqp_for_mpc_tpu.problem import PrimalQP
from pqp_for_mpc_tpu.parallel.sharded import solve_row_sharded

assert jax.process_count() == 2 and jax.device_count() == 8

# model axis SPANS the two processes: mesh column k pairs device k of
# process 0 with device k of process 1, so every model-axis
# all_gather/psum crosses the process boundary (VERDICT r1 item 5: the
# TP pattern had only ever run single-process).
devs = np.array(jax.devices()).reshape(2, 4).T      # (data=4, model=2)
mesh = Mesh(devs, ("data", "model"))
for row in devs:
    assert {d.process_index for d in row} == {0, 1}

B, M, N = 8, 8, 16
rng = np.random.default_rng(0)           # same instance on both ranks
L = rng.standard_normal((M, M)).astype(np.float32)
Qp = L @ L.T + M * np.eye(M, dtype=np.float32)
Qp_inv = np.linalg.inv(Qp).astype(np.float32)
Gp = rng.integers(-1, 2, (N, M)).astype(np.float32)
Kp = rng.uniform(1.0, 10.0, N).astype(np.float32)
Fp = rng.standard_normal((M, B)).astype(np.float32) * 5
Mp = rng.standard_normal(B).astype(np.float32)

rep = NamedSharding(mesh, P())
glob = lambda a: jax.make_array_from_callback(
    np.shape(a), rep, lambda idx: np.asarray(a)[idx])
primal = PrimalQP(Qp=glob(Qp), Qp_inv=glob(Qp_inv), Fp=glob(Fp),
                  Mp=glob(Mp), Gp=glob(Gp), Kp=glob(Kp))
dual = dualize(primal)
cfg = SolverConfig(max_iters=20_000, check_every=4, accel_every=4,
                   eaj=1e-3, erj=1e-5, strict_weak_duality=False)
res = solve_row_sharded(primal, dual, cfg=cfg, mesh=mesh)
# U is sharded (None, "data") and model-replicated: every data shard has
# one copy in THIS process — reassemble from addressable shards
def assemble(arr, shape):
    full = np.zeros(shape, np.float32)
    for s in arr.addressable_shards:
        full[s.index] = np.asarray(s.data)
    return full
U = assemble(res.U, (M, B))
conv = assemble(res.converged.astype(jnp.float32), (B,)) > 0.5
np.savez(out, U=U, conv=conv)
print("RANK", rank, "OK")
"""


@pytest.mark.slow
def test_two_process_model_axis(tmp_path):
    """Tensor-parallel solve with the model axis spanning two processes:
    every per-iteration all_gather of Y and every psum reduction crosses
    the process boundary; result must match single-process solve_batched."""
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("JAX_COMPILATION_CACHE_DIR",
                   os.path.join(REPO, ".jax_cache"))
    procs = []
    outs = [str(tmp_path / f"mrank{r}.npz") for r in range(2)]
    for r in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER_MODEL, str(r), str(port), outs[r]],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        logs.append(out.decode(errors="replace"))
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
        assert f"RANK {r} OK" in log

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from pqp_for_mpc_tpu import SolverConfig, dualize, solve_batched
    from pqp_for_mpc_tpu.problem import PrimalQP

    B, M, N = 8, 8, 16
    rng = np.random.default_rng(0)
    L = rng.standard_normal((M, M)).astype(np.float32)
    Qp = L @ L.T + M * np.eye(M, dtype=np.float32)
    # same rng DRAW ORDER as the worker (Gp, Kp, Fp, Mp) — same problem
    Gp = rng.integers(-1, 2, (N, M)).astype(np.float32)
    Kp = rng.uniform(1.0, 10.0, N).astype(np.float32)
    Fp = rng.standard_normal((M, B)).astype(np.float32) * 5
    Mp = rng.standard_normal(B).astype(np.float32)
    primal = PrimalQP(
        Qp=jnp.asarray(Qp),
        Qp_inv=jnp.asarray(np.linalg.inv(Qp).astype(np.float32)),
        Fp=jnp.asarray(Fp), Mp=jnp.asarray(Mp),
        Gp=jnp.asarray(Gp), Kp=jnp.asarray(Kp))
    ref = solve_batched(
        primal, dualize(primal),
        cfg=SolverConfig(max_iters=20_000, check_every=4, accel_every=4,
                         eaj=1e-3, erj=1e-5, strict_weak_duality=False))
    assert bool(np.asarray(ref.converged).all())
    for out in outs:
        z = np.load(out)
        assert z["conv"].all()
        np.testing.assert_allclose(z["U"], np.asarray(ref.U),
                                   rtol=5e-4, atol=5e-4)
