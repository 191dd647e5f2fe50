"""Multi-host integration: two OS processes joined by
jax.distributed.initialize on the CPU backend, one global 8-device mesh
(4 per process), a cross-process collective, and a BGN limb kernel running
SPMD over the global mesh (BASELINE.json config 5's scaffolding;
SURVEY.md §2.3 'communication backend' row).

The worker is spawned as fresh subprocesses because jax.distributed must
initialize before any backend use, which the in-process test runtime has
long done.  If the installed jaxlib lacks a CPU cross-process collectives
implementation (gloo), the workers report SKIP and so does the test.
"""

import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax
# go through jax.config too: it holds even if jax was imported before
# the env vars above were set
jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
except Exception as e:  # older/newer jaxlib: option absent
    print("MULTIHOST_SKIP no cpu collectives option:", e)
    sys.exit(42)
from bgn_jax.parallel import multihost as mh
try:
    mh.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid)
except Exception as e:
    print("MULTIHOST_SKIP distributed init failed:", e)
    sys.exit(42)

assert mh.process_info() == (pid, nproc), mh.process_info()
assert len(jax.devices()) == 4 * nproc, jax.devices()
assert len(jax.local_devices()) == 4

mesh = mh.make_global_mesh()            # (8,) over both hosts
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

# per-process batch rows -> one global sharded array
local = (np.arange(8, dtype=np.float32).reshape(4, 2) + 100.0 * pid)
g = mh.global_array_from_local(mesh, local)
assert g.shape == (4 * nproc, 2), g.shape

def f(a):
    return a * 2.0, jax.lax.psum(jnp.sum(a), "data")

out, tot = jax.jit(jax.shard_map(
    f, mesh=mesh, in_specs=P("data"), out_specs=(P("data"), P()),
    check_vma=False))(g)
want_tot = sum(float(np.sum(np.arange(8) + 100.0 * q)) for q in range(nproc))
assert float(np.asarray(tot).ravel()[0]) == want_tot, tot
assert np.array_equal(mh.local_values(out), local * 2.0)

# a BGN field kernel over the same global mesh: batched Montgomery mulmod
from bgn_jax.fieldcore import limbs as lb
from bgn_jax.fieldcore import montgomery as mg
p = (1 << 61) - 1
ctx = mg.make_mont_ctx(p)
rng = np.random.default_rng(7)
xs = [int(v) for v in rng.integers(1, p, size=4)]
ys = [int(v) for v in rng.integers(1, p, size=4)]
xl = np.asarray(lb.ints_to_limbs([x * (1 << (16 * ctx.L)) % p for x in xs],
                                 ctx.L))
yl = np.asarray(lb.ints_to_limbs([y * (1 << (16 * ctx.L)) % p for y in ys],
                                 ctx.L))
gx = mh.global_array_from_local(mesh, xl, batch_axis_pos=1)
gy = mh.global_array_from_local(mesh, yl, batch_axis_pos=1)
prod = jax.jit(mg.mont_mul)(ctx, gx, gy)
got = mh.local_values(jax.jit(mg.from_mont)(ctx, prod), batch_axis_pos=1)
for b in range(4):
    assert lb.limbs_to_int(got[:, b]) == xs[b] * ys[b] % p, b

print("MULTIHOST_OK", pid)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cpu_mesh():
    port = _free_port()
    nproc = 2
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(i), str(nproc), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=_REPO)
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(rc == 42 for rc, _ in outs):
        pytest.skip("no CPU cross-process collectives in this jaxlib:\n" +
                    outs[0][1][-500:])
    for i, (rc, out) in enumerate(outs):
        assert rc == 0, f"worker {i} failed:\n{out[-4000:]}"
        assert f"MULTIHOST_OK {i}" in out, out[-4000:]
