"""MergeCounter: streaming k-mer counter built on small sorts + bitonic merges.

MergeCounter keeps every true sort at one batch of lanes (~1M) and does all
*growth* in lane count with bitonic merges and shift-compaction
(ops/bitonic.py) -- pure static-stride elementwise stages:

  per batch:      extract canonical keys -> ONE 1-op sort of ~1M lanes
  every R batches: 1-op bitonic merge tree over the R sorted runs
                   -> one 2-op merge with the (key-sorted, deduped) store
                   -> segmented-scan RLE -> shift compaction
  finalize:       same, on the leftover runs; counts clamp at 32767
                  (itmo:utils/NumUtils.java:21-26)

Work per key at steady state: 1 sort lane + ~(1 + store/run) merge-stage
lane-sets, instead of sorting each key inside a (store+buffer)-sized
`lax.sort`, and every jit unit stays small.

Counting semantics preserved from the reference: canonical min(fw, rc) keying
(itmo:utils/KmerUtils.java:59-61), saturating counts, exact-vs-hashed regimes
(src/io/IOUtils.java:200-248, src/io/LargeKIOUtils.java:40-54).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .kmers import SENTINEL, canonical_kmers
from .bitonic import bitonic_merge, merge_rle_compact


@functools.partial(jax.jit, static_argnames=("k", "hasher", "cap"))
def _sorted_run_kernel(codes, k: int, hasher: str | None, cap: int):
    """Extract canonical keys of a (B, L) code batch and sort them into a
    run of `cap` lanes (SENTINEL-padded; SENTINEL sorts to the end)."""
    keys, _ = canonical_kmers(codes, k, hasher)
    flat = keys.ravel()
    if flat.shape[0] < cap:
        flat = jnp.concatenate(
            [flat, jnp.full((cap - flat.shape[0],), SENTINEL, jnp.int64)])
    return jax.lax.sort(flat)


@jax.jit
def _merge_runs_kernel(ka, kb):
    """1-op bitonic merge of two sorted runs (keys only, weight-1 lanes)."""
    return bitonic_merge(ka, kb)


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _consolidate_merge_kernel(store_keys, store_cnts, run_keys):
    return merge_rle_compact(store_keys, store_cnts, run_keys)


class MergeCounter:
    """Streaming counter: per-batch 1M-lane sorts + bitonic-merge consolidation.

    Same loss-proof growth protocol as StreamCounter: each consolidation
    returns the FULL compacted (store+run)-lane result; the store view keeps
    `store_cap` lanes, doubling lazily off a deferred n_distinct readback
    (resolved just before the *next* consolidation dispatch, so the sync pays
    wire latency, never compute wait).
    """

    def __init__(self, run_cap_log2: int = 20, runs_per_merge: int = 4,
                 store_cap_log2: int = 22):
        assert runs_per_merge & (runs_per_merge - 1) == 0
        self.run_cap = 1 << run_cap_log2
        self.runs_per_merge = runs_per_merge
        self.store_cap = 1 << store_cap_log2
        self.store_keys = jnp.full((self.store_cap,), SENTINEL, jnp.int64)
        self.store_cnts = jnp.zeros((self.store_cap,), jnp.int32)
        self._runs: list[jax.Array] = []
        self._live = 0
        self._pending = None  # (full_keys, full_cnts, n_distinct)

    def add_codes(self, codes: jax.Array, k: int, hasher: str | None) -> None:
        n_keys = codes.shape[0] * codes.shape[1]
        assert n_keys <= self.run_cap, (
            f"batch yields {n_keys} keys > run capacity {self.run_cap}")
        self._runs.append(_sorted_run_kernel(codes, k, hasher, self.run_cap))
        if len(self._runs) >= self.runs_per_merge:
            self._consolidate()

    def _merge_tree(self) -> jax.Array:
        runs = self._runs
        self._runs = []
        while len(runs) & (len(runs) - 1):  # pad to a power-of-2 run count
            runs.append(jnp.full((self.run_cap,), SENTINEL, jnp.int64))
        while len(runs) > 1:
            runs = [_merge_runs_kernel(runs[i], runs[i + 1])
                    for i in range(0, len(runs), 2)]
        return runs[0]

    def _resolve(self) -> None:
        if self._pending is None:
            return
        fk, fc, nd = self._pending
        self._pending = None
        self._live = int(nd)
        while self._live > self.store_cap:
            self.store_cap *= 2
        m = self.store_cap
        if fk.shape[0] >= m:
            self.store_keys, self.store_cnts = fk[:m], fc[:m]
        else:
            pad = m - fk.shape[0]
            self.store_keys = jnp.concatenate(
                [fk, jnp.full((pad,), SENTINEL, jnp.int64)])
            self.store_cnts = jnp.concatenate(
                [fc, jnp.zeros((pad,), jnp.int32)])

    def _consolidate(self) -> None:
        if not self._runs:
            return
        merged = self._merge_tree()
        self._resolve()
        self._pending = _consolidate_merge_kernel(
            self.store_keys, self.store_cnts, merged)

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """Key-sorted (keys, counts) on host, counts clamped at 32767."""
        self._consolidate()
        self._resolve()
        sk = np.asarray(self.store_keys[: max(self._live, 1)])[: self._live]
        sc = np.asarray(self.store_cnts[: max(self._live, 1)])[: self._live]
        order = np.argsort(sk, kind="stable")
        return sk[order], np.minimum(sc[order], 32767).astype(np.int32)
