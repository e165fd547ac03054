"""Bitonic merge / compaction primitives built from elementwise XLA ops.

XLA has no "merge two sorted arrays" primitive; its variadic `lax.sort` is the
only bulk reordering op. Merging a sorted run into an already sorted store
does not need a full sort, so everything in this module is built from
*static-stride slices + elementwise selects* only -- memory-bound passes with
no data-dependent addressing:

  bitonic_merge   log2(N) half-cleaner stages (reshape + min/max select)
  seg_totals      segmented per-run sums via a (flag, sum) associative scan
  compact_sorted  monotone stream compaction via log2(N) binary-decomposed
                  left-shifts (no gather/scatter: displacement D[i] = #garbage
                  before i is monotone with D[i']-D[i] <= i'-i-1 for real
                  elements, so per-bit shifting never collides)

These power the MergeCounter engine (ops/mergecount.py) and the merge-split
consolidation of ops/sortcount.py: per-batch sorts + cheap merges replace one
giant sort, preserving the reference counting semantics
(canonical min(fw,rc) keys, saturating counts; itmo:structures/map/
Long2ShortHashMap.java:119-157, itmo:utils/NumUtils.java:21-26).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .kmers import SENTINEL

# Far above the 32767 output saturation (NumUtils.addAndBound) but small
# enough that a run total (clamped store count + <=2^24 new lanes) stays
# well inside int32.
COUNT_CLAMP = 1_000_000


def _half_clean(keys, vals, stride: int):
    """One bitonic half-cleaner stage: compare-exchange at `stride`."""
    n = keys.shape[0]
    k2 = keys.reshape(n // (2 * stride), 2, stride)
    lo, hi = k2[:, 0, :], k2[:, 1, :]
    take = lo <= hi
    keys = jnp.stack([jnp.where(take, lo, hi), jnp.where(take, hi, lo)],
                     axis=1).reshape(n)
    out_vals = []
    for v in vals:
        v2 = v.reshape(n // (2 * stride), 2, stride)
        vlo, vhi = v2[:, 0, :], v2[:, 1, :]
        out_vals.append(jnp.stack([jnp.where(take, vlo, vhi),
                                   jnp.where(take, vhi, vlo)],
                                  axis=1).reshape(n))
    return keys, out_vals


def bitonic_merge(ka, kb, va=None, vb=None):
    """Merge two ascending-sorted arrays (power-of-2 total length).

    ka/kb sorted ascending (SENTINEL padding sorts to the end and is fine).
    Optional companion values va/vb travel with their keys.  Returns sorted
    keys (and merged values if given), padded to the next power-of-2 total
    length with (SENTINEL, 0).  concat(ka, reverse(kb)) is bitonic; a
    non-power-of-2 total is padded with a SENTINEL plateau *between* the
    ascending and descending parts (up, flat-at-max, down is still bitonic);
    log2(N) half-cleaner stages then fully sort it.
    """
    total = ka.shape[0] + kb.shape[0]
    n = 1 << (total - 1).bit_length()
    pad = n - total
    mid_k = [jnp.full((pad,), SENTINEL, ka.dtype)] if pad else []
    keys = jnp.concatenate([ka, *mid_k, kb[::-1]])
    vals = []
    if va is not None:
        mid_v = [jnp.zeros((pad,), va.dtype)] if pad else []
        vals = [jnp.concatenate([va, *mid_v, vb[::-1]])]
    stride = n // 2
    while stride >= 1:
        keys, vals = _half_clean(keys, vals, stride)
        stride //= 2
    if va is not None:
        return keys, vals[0]
    return keys


def _exclusive_cumsum_i32(x):
    """Exclusive int32 prefix sum (associative_scan: log-depth shifts)."""
    inc = jax.lax.associative_scan(jnp.add, x.astype(jnp.int32))
    return jnp.concatenate([jnp.zeros((1,), jnp.int32), inc[:-1]])


def seg_totals(keys, weights):
    """Per-run (run = equal adjacent keys) totals, placed at every position
    of the run via a segmented inclusive scan; callers read them at run-last
    positions.  weights int32, totals clamped implicitly by caller's input
    clamp (COUNT_CLAMP keeps any run total far inside int32)."""
    first = jnp.concatenate(
        [jnp.ones((1,), bool), keys[1:] != keys[:-1]])

    def seg_add(a, b):
        af, asum = a
        bf, bsum = b
        return af | bf, jnp.where(bf, bsum, asum + bsum)

    _, run_sum = jax.lax.associative_scan(
        seg_add, (first, weights.astype(jnp.int32)))
    return run_sum


def compact_sorted(keys, cnts, real):
    """Compact `real` positions to the front, preserving order.

    keys sorted ascending; real is a bool mask.  Non-real slots in the output
    become (SENTINEL, 0).  Uses binary decomposition of the monotone
    displacement D[i] = (# non-real before i): for bit j, elements whose D has
    that bit move left by 2^j.  Monotonicity makes every intermediate
    position distinct, so plain shifted selects (no scatter) are exact.
    Returns (keys, cnts, n_real)."""
    n = keys.shape[0]
    d = _exclusive_cumsum_i32(~real)
    keys = jnp.where(real, keys, SENTINEL)
    cnts = jnp.where(real, cnts, 0).astype(jnp.int32)
    # holes never move again (their D bit contribution must be 0)
    d = jnp.where(real, d, 0)
    n_real = jnp.sum(real).astype(jnp.int32)

    j = 0
    while (1 << j) < n:
        s = 1 << j
        moving = ((d >> j) & 1) == 1
        # value arriving at position i is the element currently at i+s
        arr_k = jnp.concatenate([keys[s:], jnp.full((s,), SENTINEL, keys.dtype)])
        arr_c = jnp.concatenate([cnts[s:], jnp.zeros((s,), jnp.int32)])
        arr_d = jnp.concatenate([d[s:], jnp.zeros((s,), jnp.int32)])
        arrives = jnp.concatenate([moving[s:], jnp.zeros((s,), bool)])
        keys = jnp.where(arrives, arr_k, jnp.where(moving, SENTINEL, keys))
        cnts = jnp.where(arrives, arr_c, jnp.where(moving, 0, cnts))
        d = jnp.where(arrives, arr_d, jnp.where(moving, 0, d))
        j += 1
    return keys, cnts, n_real


def merge_rle_compact(store_keys, store_cnts, run_keys):
    """One consolidation: merge sorted store (keys, counts) with a sorted run
    of raw keys (weight 1 each; SENTINEL = padding), sum per-key, compact.

    Returns (keys, cnts, n_distinct) at full (store+run)-lane length with the
    distinct keys sorted at the front -- like sortcount._consolidate_full_kernel,
    growth is "keep more lanes", so no key is ever lost.
    """
    store_w = jnp.minimum(store_cnts, COUNT_CLAMP).astype(jnp.int32)
    run_w = jnp.where(run_keys == SENTINEL, 0, 1).astype(jnp.int32)
    keys, w = bitonic_merge(store_keys, run_keys, store_w, run_w)
    run_sum = seg_totals(keys, w)
    last = jnp.concatenate([keys[1:] != keys[:-1], jnp.ones((1,), bool)])
    real = last & (keys != SENTINEL) & (run_sum > 0)
    out_k, out_c, n_real = compact_sorted(
        keys, jnp.minimum(run_sum, COUNT_CLAMP), real)
    return out_k, out_c, n_real
