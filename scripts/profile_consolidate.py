"""Compile and run times of the two StreamCounter consolidation pipelines.

For each total lane count (store + append buffer) it times
`_consolidate_full_split` (two full-width two-operand sorts) against
`_consolidate_merge_split` (buffer-only sort, bitonic merge stages, shift
compaction) on the same half-full store and full buffer; checks that both
give the same store, and prints one JSON line per size. This is the
measurement behind StreamCounter's choice of consolidation pipeline.

Usage: python scripts/profile_consolidate.py [min_log2] [max_log2] [reps]
       python scripts/profile_consolidate.py --sizes 20,21,24 [reps]
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

from metacherchant_tpu.ops.kmers import SENTINEL
from metacherchant_tpu.ops.sortcount import (
    _consolidate_full_split, _consolidate_merge_split)


def _inputs(rng, total):
    """Half-full sorted store (distinct keys, counts 1..5) + a full buffer
    of which half the keys repeat store keys."""
    m = total // 2
    store = np.unique(rng.integers(0, 1 << 40, size=m // 2))
    live = store.size
    sk = np.full(m, SENTINEL, np.int64)
    sk[:live] = store
    sc = np.zeros(m, np.int32)
    sc[:live] = rng.integers(1, 6, size=live)
    buf = np.where(rng.random(total - m) < 0.5,
                   rng.choice(store, size=total - m),
                   rng.integers(0, 1 << 40, size=total - m))
    return sk, sc, buf.astype(np.int64)


def _run(fn, host_inputs):
    sk, sc, buf = (jnp.asarray(x) for x in host_inputs)
    jax.block_until_ready((sk, sc, buf))
    t0 = time.perf_counter()
    out = fn(sk, sc, buf, jnp.int32(buf.shape[0]))
    jax.block_until_ready(out)
    return time.perf_counter() - t0, out


def main():
    if sys.argv[1:2] == ["--sizes"]:
        sizes = [int(x) for x in sys.argv[2].split(",")]
        reps = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    else:
        lo = int(sys.argv[1]) if len(sys.argv) > 1 else 24
        hi = int(sys.argv[2]) if len(sys.argv) > 2 else 28
        reps = int(sys.argv[3]) if len(sys.argv) > 3 else 5
        sizes = range(lo, hi + 1)
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"device {dev.platform} {dev.device_kind}; card {card.strip()}",
          flush=True)
    rng = np.random.default_rng(0)
    for log2 in sizes:
        host = _inputs(rng, 1 << log2)
        row = {"total_lanes_log2": log2}
        results = {}
        for name, fn in (("sort2", _consolidate_full_split),
                         ("merge", _consolidate_merge_split)):
            first, out = _run(fn, host)
            times = [_run(fn, host)[0] for _ in range(reps)]
            nd = int(out[2])
            results[name] = (np.asarray(out[0][:nd]), np.asarray(out[1][:nd]))
            row[name] = {"first_s": first, "median_s": float(np.median(times)),
                         "min_s": min(times), "max_s": max(times)}
            del out
        ka, ca = results["sort2"]
        row["equal"] = all(np.array_equal(ka, kb) and np.array_equal(ca, cb)
                           for kb, cb in results.values())
        row["device"] = {"platform": dev.platform, "kind": dev.device_kind}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
