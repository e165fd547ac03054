"""Scaling harness for the sharded multi-device engines (counting + BFS).

BASELINE.md's scaling target (>=80% weak-scaling efficiency on counting at
2+ devices) needs real devices. On a virtual CPU mesh the devices share the
host's cores, so per-device-fixed "weak scaling" cannot hold step time
constant even for a perfect engine (total work grows with n on fixed
silicon). What a virtual mesh CAN measure, and what this script reports
(one series per engine):

1. `sharded_count_protocol_overhead`: FIXED total work, mesh n in {1,2,4,8}.
   On fixed silicon an overhead-free sharding protocol keeps wall time
   constant (or below t(1)). overhead_pct(n) = t(n)/min_m t(m) - 1
   isolates the cost of the sharding machinery itself -- per-shard dedup,
   owner bucketing, all_to_all, fragmented inserts. The interconnect term is
   not emulated on the CPU; on a host with several GPUs the same script (run
   without JAX_PLATFORMS=cpu) measures true scaling.
2. `sharded_bfs_protocol_overhead`: the same for the sharded
   frontier-exchange BFS (fixed graph + seeds).

Methodology details (all modes):
- tables pre-sized so NO growth/sync event fires inside a timed chain
  (growth is a rare amortized event, not steady state)
- device batches pre-staged onto the mesh before t0 (host packing is a
  per-host cost; on a virtual mesh it would serially charge one host with
  all n devices' packing)
- median of R reps of each chain length; difference method
  (T(M_big)-T(M_small)) cancels residual constants

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/bench_scaling.py
"""
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import metacherchant_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from metacherchant_tpu.parallel.sharded_count import ShardedCounter, make_mesh

K = 31
PER_DEV_BATCH = int(os.environ.get("MC_SCALE_BATCH", "256"))
TOTAL_BATCH = int(os.environ.get("MC_SCALE_TOTAL", "2048"))
LEN = int(os.environ.get("MC_SCALE_LEN", "128"))
M_SMALL, M_BIG = 4, 12
REPS = int(os.environ.get("MC_SCALE_REPS", "5"))
CAP_LOG2 = int(os.environ.get("MC_SCALE_CAP", "19"))  # no growth mid-chain


def _batches(batch: int, m: int) -> list[np.ndarray]:
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, size=200000).astype(np.int8)
    win = np.arange(LEN)
    return [
        genome[rng.integers(0, genome.size - LEN, size=batch)[:, None]
               + win[None, :]].astype(np.int32)
        for _ in range(m)
    ]


def count_step_time(n_dev: int, batch: int) -> float:
    """Median steady-state step time of the sharded counting step at mesh
    n_dev with `batch` total reads/step (batch must divide by n_dev)."""
    mesh = make_mesh(jax.devices()[:n_dev])
    raw = _batches(batch, M_BIG)

    def chain(m: int) -> float:
        sc = ShardedCounter(mesh, K, None,
                            capacity_log2_per_shard=CAP_LOG2,
                            batch=batch, max_len=LEN, overflow_buf=4096)
        staged = [jax.device_put(jnp.asarray(b), sc.batch_sharding)
                  for b in raw[:m]]
        jax.block_until_ready(staged)
        t0 = time.perf_counter()
        for d in staged:
            (sc.tkeys, sc.tcnts, sc.ov_keys, sc.ov_cnts,
             new, tf, cf) = sc.step(
                sc.tkeys, sc.tcnts, sc.ov_keys, sc.ov_cnts, d)
        jax.block_until_ready((sc.tkeys, sc.tcnts))
        return time.perf_counter() - t0

    chain(2)  # compile warm
    ts = statistics.median(chain(M_SMALL) for _ in range(REPS))
    tb = statistics.median(chain(M_BIG) for _ in range(REPS))
    return max(tb - ts, 1e-9) / (M_BIG - M_SMALL)


def bfs_step_time(n_dev: int) -> float:
    """Median per-layer time of the sharded frontier-exchange BFS on a fixed
    linear-genome graph (fixed total work across mesh sizes)."""
    from metacherchant_tpu.kmer_map import KmerMap
    from metacherchant_tpu.counting import count_sequences_host
    from metacherchant_tpu.parallel.sharded_bfs import run_sharded_bfs

    mesh = make_mesh(jax.devices()[:n_dev])
    rng = np.random.default_rng(1)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, size=60000)])
    kmap = count_sequences_host([genome], K)
    seeds = kmap.keys[:: max(len(kmap) // 256, 1)][:256].copy()

    def run() -> float:
        t0 = time.perf_counter()
        visited = run_sharded_bfs(seeds, kmap, K, 1, 0, 40, mesh)
        jax.block_until_ready(visited) if hasattr(visited, "block_until_ready") \
            else None
        return time.perf_counter() - t0

    run()  # compile warm
    return statistics.median(run() for _ in range(REPS))


def main() -> None:
    avail = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8) if n <= avail]
    print(f"devices available: {avail}; host cores: {os.cpu_count()}; "
          f"meshes: {sizes}", file=sys.stderr)

    print(json.dumps({
        "metric": "methodology",
        "note": ("Fixed-total-work series on a 2-core host emulating the "
                 "mesh with virtual CPU devices: an overhead-free sharding "
                 "protocol keeps wall time at or below t(mesh=1), so "
                 "overhead_pct = t(n)/min_m t(m) - 1 bounds the software "
                 "cost of the sharded path (dedup, owner bucketing, "
                 "all_to_all, fragmented inserts). The plateau across "
                 "meshes is the host-core ceiling, not a protocol "
                 "property. The >=80% BASELINE weak-scaling target needs "
                 "real devices; this same script without "
                 "JAX_PLATFORMS=cpu measures it there."),
    }))

    # 1. counting protocol overhead: fixed total work
    results = []
    for n in sizes:
        t = count_step_time(n, TOTAL_BATCH)
        results.append((n, t))
    tmin = min(t for _, t in results)
    t1 = results[0][1]
    for n, t in results:
        print(json.dumps({
            "metric": "sharded_count_protocol_overhead",
            "mesh": n, "total_reads_per_step": TOTAL_BATCH,
            "step_ms": round(t * 1000, 1),
            "keys_per_s": round(TOTAL_BATCH * (LEN - K + 1) / t, 1),
            "efficiency_vs_1dev": round(t1 / t, 3),
            "overhead_pct": round(100 * (t / tmin - 1), 1),
        }))
        sys.stdout.flush()

    # 2. sharded BFS protocol overhead (fixed graph + seeds)
    results = []
    for n in sizes:
        results.append((n, bfs_step_time(n)))
    tmin = min(t for _, t in results)
    t1 = results[0][1]
    for n, t in results:
        print(json.dumps({
            "metric": "sharded_bfs_protocol_overhead",
            "mesh": n, "wall_s": round(t, 3),
            "efficiency_vs_1dev": round(t1 / t, 3),
            "overhead_pct": round(100 * (t / tmin - 1), 1),
        }))
        sys.stdout.flush()


if __name__ == "__main__":
    main()
