"""Dense-frontier device BFS over a precomputed de Bruijn adjacency.

The probe engine (ops/bfs_device.py) probes an open-addressing table with
data-dependent while_loop rounds of random gathers EVERY layer. This engine
applies the counting stack's approach -- bulk sorts instead of random
probing -- to the traversal itself:

1. BUILD (once per count map): join the 8 neighbor candidates of every
   oriented k-mer in the map against the sorted key store with a
   sort-merge join, producing a dense integer adjacency `adj[(2N, 8)]`
   (oriented node id = 2*canonical_rank + orientation bit). The join is
   two bulk 2-operand sorts per query group -- the same (int64, int64)
   lax.sort unit the counting consolidation uses
   (ops/sortcount._sort2_kernel) -- plus native cummax/cumsum marking.
   No probing, no scatters.

2. TRAVERSE: frontier and visited are dense bitmaps over oriented node
   ids. One layer = one bounded gather `frontier[adj]` (indices are a
   fixed array; no data-dependent probe rounds) + elementwise and/or/not.
   Dedup and the visited-set anti-join are FREE (bitmaps cannot hold
   duplicates); there are no per-layer sorts and no scatters anywhere.
   The whole BFS runs in one jitted lax.while_loop -- zero host syncs.

Per-layer cost is O(map) regardless of frontier width, so the engine
targets the WIDE-frontier flood regime (recipient-visualiser-style
many-seed, radius-capped sweeps, RecipientVisualiser.java:65-68); the
deep-narrow per-gene regime stays on the host FIFO
(src/algo/OneSequenceCalculator.java:198-213 is the reference loop both
engines reproduce set-for-set).

Exact regime only (2-bit codes, k <= 31). MAX_KMERS / lastKmers stay on
the host FIFO engine (admission-order dependent, TerminationMode.java:38-39).
Set-equivalence vs algo.environment.bfs_layered is pinned in
tests/test_bfs_dense.py.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .kmers import SENTINEL

# sort key for pad lanes: strictly greater than any real combined key
# (canonical codes are < 2^62 - 1, so (code << 1) | tag <= 2^63 - 3)
_MAXKEY = np.int64(2**63 - 1)


# ---------------------------------------------------------------------------
# Build: oriented nodes, neighbor queries, sort-merge join
# ---------------------------------------------------------------------------

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


@functools.partial(jax.jit, static_argnames=("k",))
def _oriented_queries(keys_pad: jax.Array, k: int):
    """(Np,) padded canonical keys -> oriented codes + neighbor queries.

    Returns (ocodes (2Np,), qcanon (16Np,), qbit (16Np,) int8): for every
    oriented node (id 2i = canonical, 2i+1 = revcomp) the 8 neighbor codes
    in column order [left nuc 0..3 | right nuc 0..3]
    (StringUtils.leftNeighbors/rightNeighbors, src/utils/StringUtils.java:
    8-22), canonicalized, with the orientation bit of the neighbor's
    oriented code. SENTINEL propagates through pad lanes."""
    kp = keys_pad
    bad = kp == SENTINEL
    rc = jnp.where(bad, SENTINEL, _revcomp_dev(kp, k))
    ocodes = jnp.stack([kp, rc], axis=1).reshape(-1)          # (2Np,)

    mask = np.int64((1 << (2 * k)) - 1)
    shift_hi = np.int64(2 * k - 2)
    nucs = jnp.arange(4, dtype=jnp.int64)
    left = (ocodes[:, None] >> 2) | (nucs[None, :] << shift_hi)
    right = ((ocodes[:, None] << 2) & mask) | nucs[None, :]
    nbr = jnp.concatenate([left, right], axis=1)              # (2Np, 8)
    obad = (ocodes == SENTINEL)[:, None]
    nbr = jnp.where(obad, SENTINEL, nbr)

    nrc = _revcomp_dev(nbr, k)
    canon = jnp.minimum(nbr, nrc)
    canon = jnp.where(nbr == SENTINEL, SENTINEL, canon)
    bit = (nbr != canon).astype(jnp.int8)                     # rc orientation
    return ocodes, canon.reshape(-1), bit.reshape(-1)


@functools.partial(jax.jit, donate_argnums=(1,))
def _join_prep(skeys_pad: jax.Array, qgroup: jax.Array):
    """Combined sort keys + payloads for one join group.

    combined = (code << 1) | is_query makes store lanes order BEFORE query
    lanes of the same code under a plain 1-key sort (no stability needed),
    so the cached counting sort2 executable is reused verbatim. Pad lanes
    get _MAXKEY (> any real combined key)."""
    sk = jnp.where(skeys_pad == SENTINEL, _MAXKEY, skeys_pad << 1)
    qk = jnp.where(qgroup == SENTINEL, _MAXKEY, (qgroup << 1) | 1)
    combined = jnp.concatenate([sk, qk])
    pay = jax.lax.broadcasted_iota(jnp.int64, (combined.shape[0], 1), 0)[:, 0]
    return combined, pay


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _join_mark(ks: jax.Array, ps: jax.Array, np_lanes: int, n_real):
    """Post-sort marking: per lane, the rank of the last real store lane at
    or before it (cumsum) and that lane's raw key (cummax; store ranks and
    keys are BOTH ascending in sorted order, so max-so-far == last-seen).
    A query lane matched iff the propagated key equals its own."""
    is_store = (ps < np_lanes) & (ps < n_real)
    raw = ks >> 1
    cm_raw = jax.lax.cummax(jnp.where(is_store, raw, jnp.int64(-1)))
    cm_idx = jnp.cumsum(is_store.astype(jnp.int64)) - 1
    match = (ps >= np_lanes) & (cm_raw == raw) & (ks != _MAXKEY)
    idx = jnp.where(match, cm_idx, jnp.int64(-1))
    return ps, idx


@functools.partial(jax.jit, static_argnames=("pad_id",),
                   donate_argnums=(0, 1))
def _assemble_adj(idx_flat: jax.Array, bit_flat: jax.Array, pad_id: int):
    """(16Np,) store ranks (-1 absent) + orientation bits -> (2Np, 8) int32
    oriented neighbor ids; absent -> pad_id (an always-False gather lane)."""
    ids = jnp.where(idx_flat >= 0, 2 * idx_flat + bit_flat.astype(jnp.int64),
                    jnp.int64(pad_id)).astype(jnp.int32)
    return ids.reshape(-1, 8)


#: largest join sort: 2^28 lanes of (int64, int64) is 4 GiB of operands,
#: the largest two-operand sort measured on the card
#: (scripts/profile_consolidate.py)
JOIN_LANE_CAP = 1 << 28


def _join_lane_budget(np_lanes: int) -> int:
    """Total sort lanes for one join group: 8*Np (three groups cover the
    16*Np queries) up to JOIN_LANE_CAP; above it 2*Np, so the budget always
    exceeds the store and huge maps build instead of raising."""
    total = min(8 * np_lanes, JOIN_LANE_CAP)
    if total <= np_lanes:
        total = 2 * np_lanes
    return total


def _join_store(skeys_pad: jax.Array, qcanon: jax.Array, n_real: int,
                total_lanes: int) -> jax.Array:
    """Sort-merge join of all queries against the padded sorted store.

    Splits queries into groups of (total_lanes - Np) so every sort runs at
    exactly `total_lanes` lanes: one compiled sort for all groups. Returns
    (len(qcanon),) int64 store ranks, -1 for absent."""
    from .sortcount import _sort2_kernel
    np_lanes = skeys_pad.shape[0]
    group = total_lanes - np_lanes
    if group <= 0:
        raise ValueError("join lane budget smaller than the store")
    nq = qcanon.shape[0]
    n_groups = -(-nq // group)
    pad_q = n_groups * group - nq
    if pad_q:
        qcanon = jnp.concatenate(
            [qcanon, jnp.full((pad_q,), SENTINEL, jnp.int64)])
    outs = []
    for g in range(n_groups):
        qg = jax.lax.dynamic_slice(qcanon, (g * group,), (group,))
        combined, pay = _join_prep(skeys_pad, qg)
        ks, ps = _sort2_kernel(combined, pay)
        ps2, idx = _join_mark(ks, ps, np_lanes, jnp.int64(n_real))
        _, unsorted = _sort2_kernel(ps2, idx)
        outs.append(unsorted[np_lanes:])
    res = jnp.concatenate(outs) if len(outs) > 1 else outs[0]
    return res[:nq]


class DenseDBG:
    """Precomputed dense adjacency over a KmerMap's canonical key store.

    Build cost is O(map * 8) bulk-sort lanes, paid ONCE per map and
    amortized over every BFS that follows (environment-finder-multi runs
    hundreds of per-gene traversals over one shared map). Memory: 32 B
    per canonical k-mer (the (2Np, 8) int32 adjacency) in HBM.
    """

    def __init__(self, keys: np.ndarray, counts: np.ndarray, k: int):
        if k > 31:
            raise ValueError("dense BFS engine is exact-regime only (k<=31)")
        self.k = k
        self.n = int(keys.size)
        np_lanes = 1 << max(int(np.ceil(np.log2(self.n + 1))), 9)
        self.np_lanes = np_lanes
        self.pad_id = 2 * np_lanes
        self.keys_host = np.asarray(keys, np.int64)
        self.counts_host = np.asarray(counts, np.int64)

        keys_pad = np.full(np_lanes, SENTINEL, np.int64)
        keys_pad[: self.n] = self.keys_host
        kd = jnp.asarray(keys_pad)
        ocodes, qcanon, qbit = _oriented_queries(kd, k)
        idx = _join_store(kd, qcanon, self.n, _join_lane_budget(np_lanes))
        self.adj = _assemble_adj(idx, qbit, self.pad_id)       # (2Np, 8)
        cnts_pad = np.zeros(np_lanes, np.int64)
        cnts_pad[: self.n] = self.counts_host
        self.counts_dev = jnp.asarray(cnts_pad)
        self._eligible_cache: dict[int, jax.Array] = {}

    def eligible(self, min_occ: int) -> jax.Array:
        """(2Np,) oriented-node admissibility: canonical count >= min_occ
        (OneSequenceCalculator.runBfs:203 coverage check). Pad lanes False."""
        got = self._eligible_cache.get(min_occ)
        if got is None:
            got = _eligible_kernel(self.counts_dev, jnp.int64(min_occ))
            self._eligible_cache[min_occ] = got
        return got

    def seed_vector(self, seed_codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Host: oriented codes -> (dense bool (2Np,), out-of-map mask)."""
        seed_codes = np.asarray(seed_codes, np.int64)
        if self.n == 0:  # empty map: every seed is out-of-map
            return np.zeros(2 * self.np_lanes, bool), np.ones(
                seed_codes.size, bool)
        from ..dna import revcomp_codes_np
        canon = np.minimum(seed_codes, revcomp_codes_np(seed_codes, self.k))
        pos = np.searchsorted(self.keys_host, canon)
        pos_c = np.minimum(pos, self.n - 1)
        in_map = self.keys_host[pos_c] == canon
        bit = (seed_codes != canon).astype(np.int64)
        ids = 2 * pos_c + bit
        dense = np.zeros(2 * self.np_lanes, bool)
        dense[ids[in_map]] = True
        return dense, ~in_map

    def ids_to_codes(self, ids: np.ndarray) -> np.ndarray:
        """Oriented node ids -> oriented codes (host)."""
        from ..dna import revcomp_codes_np
        canon = self.keys_host[ids >> 1]
        rc = revcomp_codes_np(canon, self.k)
        return np.where(ids & 1, rc, canon)


@functools.partial(jax.jit, donate_argnums=())
def _eligible_kernel(counts_pad: jax.Array, min_occ):
    ok = counts_pad >= min_occ
    return jnp.stack([ok, ok], axis=1).reshape(-1)


# ---------------------------------------------------------------------------
# Traverse: dense bitmap layers inside one while_loop
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("direction",))
def dense_bfs(adj: jax.Array, eligible: jax.Array, seeds: jax.Array,
              max_radius, direction: int):
    """Whole BFS in one dispatch over dense oriented-node bitmaps.

    direction 0: all 8 columns. +1 (right-extension BFS): node i joins the
    frontier iff one of its LEFT neighbors is in it (x right-extends to i
    <=> i left-shrinks to x, so in-neighbors under right moves are i's
    left-extension ids); -1 symmetric. Pull formulation: no scatters, the
    bitmap IS the dedup and the visited anti-join.

    Returns (visited (2Np,) bool, n_visited, n_layers)."""
    if direction == 1:
        adj_sel = adj[:, 0:4]
    elif direction == -1:
        adj_sel = adj[:, 4:8]
    else:
        adj_sel = adj

    def cond(state):
        frontier, _, d, _ = state
        return jnp.any(frontier) & (d <= max_radius)

    def body(state):
        frontier, visited, d, layers = state
        f_ext = jnp.concatenate([frontier, jnp.zeros((1,), bool)])
        cand = f_ext[adj_sel].any(axis=1)
        fresh = cand & eligible & ~visited
        return fresh, visited | fresh, d + 1, layers + 1

    frontier, visited, _, layers = jax.lax.while_loop(
        cond, body, (seeds, seeds, jnp.int32(1), jnp.int32(0)))
    return visited, jnp.sum(visited).astype(jnp.int32), layers


def _graph_of(kmap, k: int) -> DenseDBG:
    """Build-or-reuse the DenseDBG for a KmerMap (cached on the map: the
    multi-gene tools run hundreds of BFS passes over one shared map)."""
    g = getattr(kmap, "_dense_dbg", None)
    if g is None or g.k != k:
        g = DenseDBG(kmap.keys, kmap.counts, k)
        kmap._dense_dbg = g
    return g


def run_dense_bfs(seed_codes: np.ndarray, kmap, k: int, min_occ: int,
                  direction: int, max_radius: int | None) -> np.ndarray:
    """Host wrapper: sorted oriented visited codes, set-identical to
    algo.environment.bfs_layered (radius-only termination).

    Out-of-map seeds (possible only when min_occ <= 0 upstream) are handled
    by a second pass: their eligible in-map neighbors are distance-1
    sources, and multi-source BFS with per-source budgets decomposes into a
    union of single-budget runs."""
    if seed_codes.size == 0:
        return np.empty(0, np.int64)
    if min_occ < 0:
        # a negative threshold admits ABSENT k-mers (map lookups return -1),
        # which have no dense node id -- only the host engines can expand
        # through them
        raise ValueError("dense BFS requires min_occ >= 0")
    g = _graph_of(kmap, k)
    mr = jnp.int32(min(max_radius if max_radius is not None else (1 << 30),
                       1 << 30))
    elig = g.eligible(min_occ)
    seeds_dense, oom = g.seed_vector(seed_codes)

    visited, _, _ = dense_bfs(g.adj, elig, jnp.asarray(seeds_dense), mr,
                              direction)
    parts = []
    if oom.any():
        # out-of-map seeds: admit them verbatim (bfs_layered admits every
        # seed), then flood from their eligible neighbors with radius-1
        from ..dna import revcomp_codes_np
        oom_codes = np.unique(seed_codes[oom])
        parts.append(oom_codes)
        if max_radius is None or max_radius >= 1:
            from ..algo.environment import neighbors_codes
            nbr = neighbors_codes(oom_codes, k, direction).reshape(-1)
            canon = np.minimum(nbr, revcomp_codes_np(nbr, k))
            occs = kmap.get_many(canon)
            nbr = nbr[occs >= min_occ]
            if nbr.size:
                d2, oom2 = g.seed_vector(nbr)
                if oom2.any():  # pragma: no cover - min_occ>=0 guarantees it
                    raise RuntimeError("dense BFS: covered neighbor not in map")
                mr2 = jnp.int32(mr - 1)
                v2, _, _ = dense_bfs(g.adj, elig, jnp.asarray(d2), mr2,
                                     direction)
                visited = visited | v2
    vh = np.asarray(visited)
    ids = np.flatnonzero(vh)
    parts.append(g.ids_to_codes(ids))
    out = np.unique(np.concatenate(parts))
    return out
