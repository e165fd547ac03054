"""Multi-device environment BFS: hash-sharded table + frontier all-to-all.

The SURVEY §2.3 P4 mapping: the reference's serial FIFO BFS
(src/algo/OneSequenceCalculator.java:198-213) becomes a layer-synchronous
frontier iteration where BOTH the coverage table and the visited set are
sharded over the device mesh by canonical-key hash (the same owner function
as sharded counting: mix64(key) mod n), and each layer's candidate states are
routed to their owner shard with one all_to_all:

  per layer, per shard (shard_map over "d"):
    1. expand the local frontier (4/8 neighbor codes via bit ops)
    2. dedup locally, bucket by owner(canonical(candidate)), all_to_all
    3. on the owner: probe the local table shard (count >= min_occ), anti-join
       + insert into the local ORIENTED visited set
    4. admitted states ARE the owner's next local frontier (states live where
       their canonical key lives -- no route-back hop)
    5. termination: psum(new admissions) == 0, or layer > max_radius
       (TerminationMode.java MAX_RADIUS; order-dependent MAX_KMERS stays on
       the host FIFO engine)

The whole traversal runs inside one jitted lax.while_loop with the
collectives in the body -- one dispatch per BFS, no host round-trips.
Set-equivalence to the host engine is deterministic by construction (visited
membership is order-free; admission layer = BFS distance).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.kmers import SENTINEL
from ..ops.hashtable import _mix64, EMPTY, _insert_unique_impl
from ..ops.bfs_device import (
    _neighbors_dev, _canonical_dev, _set_insert, _unique_pad,
    _table_lookup)


def _owner(keys: jax.Array, n: int) -> jax.Array:
    return (_mix64(keys) % jnp.uint64(n)).astype(jnp.int32)


def _bucket_states(states: jax.Array, n: int, cap: int, k: int):
    """Pack oriented states into (n, cap) buckets by owner(canonical(state)).
    Returns (buckets, overflowed)."""
    canon = _canonical_dev(states, k)
    owner = jnp.where(states == SENTINEL, n, _owner(canon, n))
    order = jnp.argsort(owner, stable=True)
    so, ss = owner[order], states[order]
    idx = jnp.arange(so.shape[0], dtype=jnp.int32)
    first = jnp.concatenate([jnp.zeros((1,), bool), so[1:] != so[:-1]])
    start = jax.lax.associative_scan(jnp.maximum, jnp.where(first, idx, 0))
    rank = idx - start
    ok = (rank < cap) & (so < n)
    overflow = jnp.any((~ok) & (so < n))
    dest = jnp.where(ok, so * cap + rank, n * cap)
    bk = jnp.full((n * cap + 1,), SENTINEL, jnp.int64).at[dest].set(
        ss, mode="drop")[: n * cap]
    return bk.reshape(n, cap), overflow


def make_sharded_bfs(mesh: Mesh, k: int, direction: int, frontier_cap: int,
                     visited_log2: int, bucket_cap: int):
    """Returns bfs(seeds, tkeys, tcnts, min_occ, max_radius) ->
    (visited_sets, n_visited, overflowed); all arrays sharded over "d"."""
    axis = mesh.axis_names[0]
    n = mesh.devices.size
    D = 8 if direction == 0 else 4
    vcap = 1 << visited_log2

    def local_bfs(seeds, tkeys, tcnts, min_occ, max_radius):
        seeds, tkeys, tcnts = seeds[0], tkeys[0], tcnts[0]
        vset = jnp.full((vcap,), EMPTY, jnp.int64)
        useeds = _unique_pad(seeds)
        vset, n0, _ = _set_insert(vset, useeds)
        frontier = jnp.full((frontier_cap,), SENTINEL, jnp.int64)
        ncopy = min(useeds.shape[0], frontier_cap)
        frontier = jax.lax.dynamic_update_slice(
            frontier, jnp.sort(useeds)[:ncopy], (0,))
        total0 = jax.lax.psum(n0, axis)
        any_front0 = jax.lax.psum(
            jnp.sum(frontier != SENTINEL), axis) > 0

        def cond(state):
            _, _, _, d, overflow, active = state
            return active & (d <= max_radius) & ~overflow

        def body(state):
            frontier, vset, count, d, overflow, _ = state
            cand = _neighbors_dev(frontier, k, direction)        # (F*D,)
            cand = _unique_pad(cand)                             # local dedup
            bk, ovf1 = _bucket_states(cand, n, bucket_cap, k)
            rk = jax.lax.all_to_all(bk, axis, split_axis=0, concat_axis=0,
                                    tiled=True).ravel()
            occs = _table_lookup(tkeys, tcnts, _canonical_dev(rk, k))
            rk = jnp.where(occs >= min_occ, rk, SENTINEL)
            rk = _unique_pad(rk)
            # combined membership-test-and-insert (winner mask): one probe
            # loop per layer instead of two (as ops/bfs_device.py round 4)
            vset, new, winner = _set_insert(vset, rk)
            fresh = jnp.sort(jnp.where(winner, rk, SENTINEL))
            ovf2 = new > frontier_cap
            next_frontier = jax.lax.dynamic_slice(fresh, (0,), (frontier_cap,))
            overflow = overflow | jax.lax.psum(
                (ovf1 | ovf2).astype(jnp.int32), axis) > 0
            total_new = jax.lax.psum(new, axis)
            return (next_frontier, vset, count + new, d + 1, overflow,
                    total_new > 0)

        frontier, vset, count, _, overflow, _ = jax.lax.while_loop(
            cond, body,
            (frontier, vset, n0, jnp.int32(1), jnp.bool_(False), any_front0))
        total = jax.lax.psum(count, axis)
        return vset[None], total[None], overflow[None]

    spec = P(axis)
    return jax.jit(
        shard_map(local_bfs, mesh=mesh,
                  in_specs=(spec, spec, spec, P(), P()),
                  out_specs=(spec, spec, spec),
                  check_vma=False),
        static_argnums=())


def build_sharded_table(kmap, mesh: Mesh, capacity_log2: int | None = None):
    """Partition a KmerMap into per-device open-addressing shards by
    owner(key) = mix64(key) mod n. Returns (tkeys, tcnts) sharded over "d"."""
    n = mesh.devices.size
    axis = mesh.axis_names[0]
    keys, counts = kmap.keys, kmap.counts
    # host-side owner split (one-time setup; counting produces this layout
    # natively when the map was built by ShardedCounter)
    owner = np.asarray(
        _owner(jnp.asarray(keys), n)) if keys.size else np.empty(0, np.int32)
    per_shard = np.bincount(owner, minlength=n) if keys.size else np.zeros(n, int)
    need = max(int(per_shard.max()) if keys.size else 1, 1)
    if capacity_log2 is None:
        capacity_log2 = max(int(np.ceil(np.log2(need / 0.5 + 1))), 6)
    cap = 1 << capacity_log2
    pad = 1 << int(np.ceil(np.log2(need + 1)))
    bk = np.full((n, pad), SENTINEL, np.int64)
    bc = np.zeros((n, pad), np.int32)
    for s in range(n):
        sel = owner == s
        cnt = int(sel.sum())
        bk[s, :cnt] = keys[sel]
        bc[s, :cnt] = counts[sel]

    sharding = jax.NamedSharding(mesh, P(axis))

    def init(bk, bc):
        tkeys = jnp.full((1, cap), EMPTY, jnp.int64)
        tcnts = jnp.zeros((1, cap), jnp.int32)
        tk, tc, _, ovf = _insert_unique_impl(tkeys[0], tcnts[0], bk[0], bc[0])
        return tk[None], tc[None], ovf[None]

    tkeys, tcnts, ovf = jax.jit(shard_map(
        init, mesh=mesh, in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)), check_vma=False))(
        jax.device_put(jnp.asarray(bk), sharding),
        jax.device_put(jnp.asarray(bc), sharding))
    if bool(np.asarray(ovf).any()):  # pragma: no cover - cap sized above
        raise RuntimeError("sharded table build overflow")
    return tkeys, tcnts


def run_sharded_bfs(seed_codes: np.ndarray, kmap, k: int, min_occ: int,
                    direction: int, max_radius: int | None,
                    mesh: Mesh | None = None,
                    frontier_cap: int | None = None) -> np.ndarray:
    """Host wrapper: sorted oriented visited codes across all shards.

    frontier_cap bounds the per-shard per-layer frontier; the default (2x
    the per-shard map size) is always safe but oversized for sparse
    seedings -- the per-layer bucket/scatter lanes scale with cap*D, so a
    tight cap matters on a live chip (overflow is detected on device and
    raised here, never silently dropped)."""
    from .sharded_count import make_mesh
    mesh = mesh or make_mesh()
    n = mesh.devices.size
    axis = mesh.axis_names[0]
    if seed_codes.size == 0:
        return np.empty(0, np.int64)

    est = max(len(kmap), 1)
    requested_cap = frontier_cap
    if frontier_cap is None:
        frontier_cap = 1 << max(int(np.ceil(np.log2(2 * est / n + 2))) + 1, 6)
    else:
        frontier_cap = 1 << int(np.ceil(np.log2(max(frontier_cap, 64))))
    visited_log2 = max(int(np.ceil(np.log2(2 * est / n / 0.5 + 2))) + 1, 6)
    D = 8 if direction == 0 else 4
    bucket_cap = max((frontier_cap * D) // n * 2, 64)

    # bucket seeds by owner(canonical(seed)) host-side. Dedup FIRST: the
    # device frontier init dedups oriented seeds anyway (_unique_pad), so
    # counting raw seeds against the cap would falsely refuse
    # duplicate-heavy seed lists (seed_codes_of_sequences emits every
    # window without dedup), and pre-deduping also shrinks the seed buffer
    seeds = np.unique(np.asarray(seed_codes, np.int64))
    canon = np.asarray(_canonical_dev(jnp.asarray(seeds), k))
    owner = np.asarray(_owner(jnp.asarray(canon), n))
    max_bucket = int(np.bincount(owner, minlength=n).max())
    if max_bucket > frontier_cap:
        # the device frontier init copies at most frontier_cap seeds per
        # shard; a caller-tightened cap below the (unique) seed load would
        # SILENTLY drop seeds, so refuse loudly BEFORE the expensive table
        # build (the default cap always fits: unique seeds <= map keys)
        raise ValueError(
            f"frontier_cap {requested_cap} (rounded {frontier_cap}) below "
            f"the densest seed shard ({max_bucket} unique seeds)")
    scap = 1 << max(int(np.ceil(np.log2(max_bucket + 1))), 4)
    sk = np.full((n, scap), SENTINEL, np.int64)
    for s in range(n):
        sel = seeds[owner == s]
        sk[s, : sel.size] = sel

    tkeys, tcnts = build_sharded_table(kmap, mesh)
    bfs = make_sharded_bfs(mesh, k, direction, frontier_cap, visited_log2,
                           bucket_cap)
    sharding = jax.NamedSharding(mesh, P(axis))
    vsets, total, overflow = bfs(
        jax.device_put(jnp.asarray(sk), sharding), tkeys, tcnts,
        jnp.int32(min_occ),
        jnp.int32(max_radius if max_radius is not None else (1 << 30)))
    if bool(np.asarray(overflow).any()):
        raise RuntimeError("sharded BFS frontier/bucket overflow")
    vk = np.asarray(vsets).ravel()
    out = vk[vk != EMPTY]
    out.sort()
    return out
