"""Exact-regime extraction on the card: the XLA lax.scan against the Pallas
Triton kernel (ops/pallas_kmers.py), alone and end to end.

Alone: each route extracts the canonical keys of one (B, L) batch and
reduces them to a checksum inside the same jit, so neither can be dead-code
eliminated; the kernel's keys are first compared with the scan's for
equality. Prints one JSON line per route and kernel geometry: median, min
and max of `reps` timed calls ending in block_until_ready.

End to end (--e2e): chip_smoke.py's phase-1 community, run through the
environment-finder CLI in this process four times, alternating the routes
(scan, kernel, scan, kernel). jax.clear_caches() between runs makes each
run trace its route again; the persistent compile cache keeps the rest
compiled. Prints the CLI wall time and the counting time of each run.

Usage: python scripts/profile_pallas_extract.py [batch] [len] [reps]
       python scripts/profile_pallas_extract.py --e2e [pairs]
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import metacherchant_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from metacherchant_tpu.ops.kmers import exact_canonical_kmers
from metacherchant_tpu.ops.pallas_kmers import exact_keys_position_major

K = 31


def _time(fn, codes, reps):
    jax.block_until_ready(fn(codes))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(codes))
        times.append(time.perf_counter() - t0)
    return {"median_ms": 1e3 * float(np.median(times)),
            "min_ms": 1e3 * min(times), "max_ms": 1e3 * max(times)}


def e2e(pairs: int) -> None:
    import shutil
    import chip_smoke as cs
    from metacherchant_tpu.ops import kmers

    rng = np.random.default_rng(0)
    work = os.path.join(cs.HERE, "build", "extract_e2e")
    shutil.rmtree(work, ignore_errors=True)
    genomes, cover, r1, r2 = cs.make_community(rng, 20, 1_000_000, 2_000_000,
                                               pairs)
    genes = cs.pick_genes(rng, genomes, cover, 4, 4)
    reads, genes_path, names = cs.write_sample(work, r1, r2, genes)
    del r1, r2
    cap = cs.Capture()
    kernel_route = kmers._use_gpu_kernel
    for run, route in enumerate(("xla_scan", "pallas_triton") * 2):
        kmers._use_gpu_kernel = (kernel_route if route == "pallas_triton"
                                 else lambda hasher: False)
        jax.clear_caches()
        out = os.path.join(work, f"out{run}")
        wall = cs.run_cli(["-t", "environment-finder", "-k", str(K),
                           "-i", *reads, "--seq", genes_path, "-o", out,
                           "--coverage", "5", "--maxradius", "1000",
                           "-w", os.path.join(work, f"wd{run}"), "-p", "4"])
        print(json.dumps({"e2e_run": run, "route": route, "pairs": pairs,
                          "cli_s": wall, "count_s": cap.count_s,
                          "distinct": len(cap.kmap)}), flush=True)
        shutil.rmtree(out)
    kmers._use_gpu_kernel = kernel_route
    shutil.rmtree(work, ignore_errors=True)


def main():
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"device {dev.platform} {dev.device_kind}; card {card.strip()}",
          flush=True)
    if sys.argv[1:2] == ["--e2e"]:
        return e2e(int(sys.argv[2]) if len(sys.argv) > 2 else 1_000_000)
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    L = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 50
    rng = np.random.default_rng(0)
    codes_np = np.where(rng.random((B, L)) < 0.01, -1,
                        rng.integers(0, 4, size=(B, L))).astype(np.int32)
    codes = jnp.asarray(codes_np)
    ref = np.asarray(exact_canonical_kmers(codes, K)[0])

    xla = jax.jit(lambda c: jnp.sum(exact_canonical_kmers(c, K)[0] & 0xFFFF))
    row = {"route": "xla_scan", "B": B, "L": L, **_time(xla, codes, reps)}
    print(json.dumps(row), flush=True)
    for block_reads in (128, 256):
        for seg_len in (32, 64, L):
            got = np.asarray(exact_keys_position_major(
                codes, K, block_reads=block_reads, seg_len=seg_len))
            ok = bool(np.array_equal(got.T, ref))
            fn = jax.jit(lambda c, br=block_reads, sl=seg_len: jnp.sum(
                exact_keys_position_major(c, K, block_reads=br, seg_len=sl)
                & 0xFFFF))
            row = {"route": "pallas_triton", "block_reads": block_reads,
                   "seg_len": seg_len, "B": B, "L": L, "equal": ok,
                   **_time(fn, codes, reps)}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
