"""Whole-environment BFS as a single device dispatch.

Device replacement for the reference's serial String-keyed FIFO BFS
(src/algo/OneSequenceCalculator.java:198-213): the entire layer-synchronous
traversal runs inside one jitted lax.while_loop -- no host round-trips per
layer.

State on device:
- reads table: the (tkeys, tcnts) open-addressing count table (coverage probes)
- visited SET: open-addressing table of ORIENTED k-mer codes (Java keys its
  distance map by the literal k-mer string, not the canonical form)
- frontier: fixed-capacity SENTINEL-padded array of oriented codes

Per layer: expand frontier x D neighbor codes (bit ops), probe coverage
(count >= min_occ), dedup candidates (sort), anti-join + insert into the
visited set, build the next frontier. MAX_RADIUS is exact under layer
synchrony (FIFO distances are layer distances, TerminationMode.java:31-47);
MAX_KMERS is admission-order-dependent in Java and is handled by the host
FIFO engine instead (algo/environment.py).

Semantics identical (set-wise) to algo.environment.bfs_layered; equivalence is
tested on random graphs.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .kmers import SENTINEL
from .hashtable import _mix64, EMPTY


def _neighbors_dev(codes: jax.Array, k: int, direction: int) -> jax.Array:
    """(F,) oriented codes -> (F*D,) neighbor codes; SENTINEL propagates."""
    mask = np.int64((1 << (2 * k)) - 1)
    shift_hi = np.int64(2 * k - 2)
    nucs = jnp.arange(4, dtype=jnp.int64)
    left = (codes[:, None] >> 2) | (nucs[None, :] << shift_hi)
    right = ((codes[:, None] << 2) & mask) | nucs[None, :]
    if direction == -1:
        out = left
    elif direction == 1:
        out = right
    else:
        out = jnp.concatenate([left, right], axis=1)
    bad = (codes == SENTINEL)[:, None]
    return jnp.where(bad, SENTINEL, out).reshape(-1)


def _revcomp_dev(codes: jax.Array, k: int) -> jax.Array:
    c = codes.astype(jnp.uint64)
    c = ((c & jnp.uint64(0x3333333333333333)) << jnp.uint64(2)) | \
        ((c & jnp.uint64(0xCCCCCCCCCCCCCCCC)) >> jnp.uint64(2))
    c = ((c & jnp.uint64(0x0F0F0F0F0F0F0F0F)) << jnp.uint64(4)) | \
        ((c & jnp.uint64(0xF0F0F0F0F0F0F0F0)) >> jnp.uint64(4))
    c = ((c & jnp.uint64(0x00FF00FF00FF00FF)) << jnp.uint64(8)) | \
        ((c & jnp.uint64(0xFF00FF00FF00FF00)) >> jnp.uint64(8))
    c = ((c & jnp.uint64(0x0000FFFF0000FFFF)) << jnp.uint64(16)) | \
        ((c & jnp.uint64(0xFFFF0000FFFF0000)) >> jnp.uint64(16))
    c = ((c & jnp.uint64(0x00000000FFFFFFFF)) << jnp.uint64(32)) | \
        ((c & jnp.uint64(0xFFFFFFFF00000000)) >> jnp.uint64(32))
    c = ~c
    return (c >> jnp.uint64(64 - 2 * k)).astype(jnp.int64)


def _canonical_dev(codes: jax.Array, k: int) -> jax.Array:
    rc = _revcomp_dev(codes, k)
    out = jnp.minimum(codes, rc)
    return jnp.where(codes == SENTINEL, SENTINEL, out)


def _set_lookup(skeys: jax.Array, q: jax.Array) -> jax.Array:
    """Membership probe in an open-addressing key set; SENTINEL -> False."""
    C = skeys.shape[0]
    cmask = jnp.uint64(C - 1)
    slot0 = (_mix64(q) & cmask).astype(jnp.int32)
    active0 = q != EMPTY
    found0 = jnp.zeros(q.shape, bool)

    def cond(s):
        active, _, _, r = s
        return jnp.logical_and(jnp.any(active), r < C)

    def body(s):
        active, slot, found, r = s
        cur = skeys[slot]
        hit = jnp.logical_and(active, cur == q)
        found = jnp.logical_or(found, hit)
        stop = jnp.logical_or(hit, cur == EMPTY)
        active = jnp.logical_and(active, jnp.logical_not(stop))
        slot = jnp.where(active, (slot + 1) & jnp.int32(C - 1), slot)
        return active, slot, found, r + 1

    _, _, found, _ = jax.lax.while_loop(cond, body, (active0, slot0, found0,
                                                     jnp.int32(0)))
    return found


def _set_insert(skeys: jax.Array, bkeys: jax.Array):
    """Insert unique keys into the set; returns (skeys, n_new, winner_mask).

    winner_mask[i] is True iff bkeys[i] was NEWLY inserted -- callers use it
    as a combined membership-test-and-insert, which saves the BFS layer a
    whole separate _set_lookup while_loop of random gathers."""
    C = skeys.shape[0]
    cmask = jnp.uint64(C - 1)
    active0 = bkeys != EMPTY
    slot0 = (_mix64(bkeys) & cmask).astype(jnp.int32)
    winner0 = jnp.zeros(bkeys.shape, bool)

    def cond(s):
        _, active, _, r, _ = s
        return jnp.logical_and(jnp.any(active), r < C)

    def body(s):
        skeys, active, slot, r, winners = s
        cur = skeys[slot]
        match = jnp.logical_and(active, cur == bkeys)
        empty = jnp.logical_and(active, cur == EMPTY)
        claim = jnp.where(empty, slot, C)
        skeys = skeys.at[claim].set(bkeys, mode="drop")
        winner = jnp.logical_and(empty, skeys[slot] == bkeys)
        winners = jnp.logical_or(winners, winner)
        done = jnp.logical_or(match, winner)
        active = jnp.logical_and(active, jnp.logical_not(done))
        slot = jnp.where(active, (slot + 1) & jnp.int32(C - 1), slot)
        return skeys, active, slot, r + 1, winners

    skeys, _, _, _, winners = jax.lax.while_loop(
        cond, body, (skeys, active0, slot0, jnp.int32(0), winner0))
    return skeys, jnp.sum(winners).astype(jnp.int32), winners


def _unique_pad(keys: jax.Array) -> jax.Array:
    """Sort + dedup, duplicates/SENTINELs pushed to SENTINEL; keeps shape."""
    s = jnp.sort(keys)
    first = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    return jnp.where(first, s, SENTINEL)


@functools.partial(
    jax.jit,
    static_argnames=("k", "direction", "frontier_cap", "visited_log2"))
def device_bfs(seeds: jax.Array, tkeys: jax.Array, tcnts: jax.Array,
               min_occ: int, max_radius: int, k: int, direction: int,
               frontier_cap: int, visited_log2: int):
    """Run the full BFS on device.

    seeds: (S,) oriented codes, SENTINEL-padded.
    Returns (visited_set_keys (2^visited_log2,), n_visited, overflowed).
    max_radius: pass a huge value (2**30) for 'unbounded'.
    """
    D = 8 if direction == 0 else 4
    vcap = 1 << visited_log2
    vset = jnp.full((vcap,), EMPTY, jnp.int64)
    useeds = _unique_pad(seeds)
    vset, n0, _ = _set_insert(vset, useeds)
    frontier = jnp.full((frontier_cap,), SENTINEL, jnp.int64)
    frontier = jax.lax.dynamic_update_slice(
        frontier, _unique_pad(useeds)[: min(seeds.shape[0], frontier_cap)], (0,))

    def cond(state):
        frontier, _, _, d, overflow = state
        return (jnp.any(frontier != SENTINEL)
                & (d <= max_radius) & jnp.logical_not(overflow))

    def body(state):
        frontier, vset, count, d, overflow = state
        cand = _neighbors_dev(frontier, k, direction)          # (F*D,)
        occs = _table_lookup(tkeys, tcnts, _canonical_dev(cand, k))
        eligible = occs >= min_occ
        cand = jnp.where(eligible, cand, SENTINEL)
        cand = _unique_pad(cand)                               # sorted, deduped
        # combined membership-test-and-insert: winners are exactly the
        # not-previously-visited candidates (one probe loop, not two)
        vset, new, winner = _set_insert(vset, cand)
        fresh = jnp.where(winner, cand, SENTINEL)
        fresh = jnp.sort(fresh)                                # compact front
        overflow = jnp.logical_or(overflow, new > frontier_cap)
        next_frontier = jax.lax.dynamic_slice(fresh, (0,), (frontier_cap,))
        return next_frontier, vset, count + new, d + 1, overflow

    frontier, vset, count, _, overflow = jax.lax.while_loop(
        cond, body, (frontier, vset, n0, jnp.int32(1), jnp.bool_(False)))
    return vset, count, overflow


def _table_lookup(tkeys, tcnts, q):
    """Count probe (absent -> -1), mirroring hashtable._lookup_kernel but
    traceable inside the BFS jit."""
    from .hashtable import _lookup_kernel
    return _lookup_kernel.__wrapped__(tkeys, tcnts, q)


def run_device_bfs(seed_codes: np.ndarray, kmap_or_table, k: int,
                   min_occ: int, direction: int,
                   max_radius: int | None,
                   frontier_cap: int | None = None) -> np.ndarray:
    """Host wrapper: returns the sorted oriented visited codes (numpy).

    kmap_or_table: a KmerMap (converted to a device table view) or a
    DeviceHashTable. frontier_cap: per-layer frontier bound; defaults to
    2x the table size (always safe). Radius-capped multi-seed workloads
    should pass a tight cap -- the per-layer sorts scan frontier_cap*D
    lanes, so an oversized cap dominates layer cost. Overflow is detected
    on device and raised here, so a too-tight cap fails loudly, never
    silently drops frontier lanes.
    """
    from .hashtable import DeviceHashTable
    from ..kmer_map import KmerMap
    if isinstance(kmap_or_table, KmerMap):
        table = DeviceHashTable.from_kmer_map(kmap_or_table)
        tkeys, tcnts = table.tkeys, table.tcnts
        est = len(kmap_or_table)
    else:
        tkeys, tcnts = kmap_or_table.tkeys, kmap_or_table.tcnts
        est = kmap_or_table.size

    if seed_codes.size == 0:
        return np.empty(0, np.int64)
    scap = 1 << int(np.ceil(np.log2(seed_codes.size + 1)))
    seeds = np.full(scap, SENTINEL, np.int64)
    seeds[: seed_codes.size] = seed_codes
    visited_log2 = max(int(np.ceil(np.log2(2 * est / 0.25 + 2))), 6)
    if frontier_cap is None:
        frontier_cap = 1 << max(int(np.ceil(np.log2(2 * est + 2))), 6)
    else:
        frontier_cap = 1 << int(np.ceil(np.log2(max(frontier_cap,
                                                    seed_codes.size, 64))))
    mr = max_radius if max_radius is not None else (1 << 30)
    vset, count, overflow = device_bfs(
        jnp.asarray(seeds), tkeys, tcnts, min_occ, mr, k, direction,
        frontier_cap, visited_log2)
    if bool(overflow):
        raise RuntimeError("device BFS frontier overflow")
    vk = np.asarray(vset)
    out = vk[vk != EMPTY]
    out.sort()
    return out
