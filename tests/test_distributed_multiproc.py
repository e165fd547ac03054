"""Real 2-process jax.distributed test (CPU backend).

Exercises initialize_distributed + shard_files_for_host + a cross-process
collective -- the multi-host path (SURVEY §2.3 P5) that single-process mesh
tests cannot reach. Each worker is a separate Python process joined through a
local coordinator; worker 0 asserts the global device count and a psum over
the global mesh, and both assert disjoint round-robin file shards.
"""
import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.environ["MC_REPO"])
from metacherchant_tpu.parallel.distributed import (
    initialize_distributed, shard_files_for_host)

initialize_distributed()  # reads MC_COORDINATOR/MC_NUM_PROCESSES/MC_PROCESS_ID
assert jax.process_count() == 2, jax.process_count()
pid = jax.process_index()
assert pid == int(os.environ["MC_PROCESS_ID"])

files = [f"f{i}" for i in range(7)]
mine = shard_files_for_host(files)
want = [f for i, f in enumerate(files) if i % 2 == pid]
assert mine == want, (pid, mine)

# cross-process collective over the global mesh: psum of per-process values
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

devs = np.array(jax.devices())  # global: both processes' cpu devices
mesh = Mesh(devs, ("d",))
n = devs.size

@jax.jit
def allsum():
    def f():
        return jax.lax.psum(
            jnp.ones((), jnp.int64) * (jax.lax.axis_index("d") + 1), "d")
    return shard_map(f, mesh=mesh, in_specs=(), out_specs=P())()

total = int(allsum())
assert total == n * (n + 1) // 2, total
print(f"proc {pid}: OK devices={n} psum={total}", flush=True)
"""


def test_two_process_distributed_counting(tmp_path):
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            MC_REPO=repo,
            MC_COORDINATOR=f"127.0.0.1:{port}",
            MC_NUM_PROCESSES="2",
            MC_PROCESS_ID=str(pid),
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
        )
        env.pop("JAX_PLATFORMS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid}: OK devices=4 psum=10" in out, out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
