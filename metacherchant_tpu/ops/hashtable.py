"""Device-resident open-addressing k-mer count table (functional JAX).

Replacement for the reference's striped concurrent hash map
(itmo:structures/map/BigLong2ShortHashMap.java:62-253,
itmo:structures/map/Long2ShortHashMap.java:76-157): the de Bruijn graph IS this
map (canonical k-mer key -> saturating count). Java resolves contention with
per-stripe locks; here a whole batch of unique keys is inserted per step with
vectorized probe rounds:

  round: gather table keys at probe slots; matched keys scatter-add their
  counts; keys landing on EMPTY slots all scatter their key and read the slot
  back -- the one lane that sees its own key wins the slot, losers advance to
  the next slot (linear probing), repeat.

Expected rounds ~ O(1/(1-load)); every round is pure gather/scatter over
device memory.

Host<->device sync discipline: a synchronous scalar readback stalls the host
until the device drains its queue, so the table NEVER syncs on the hot path. The live size is accumulated in a device scalar; the host tracks
a conservative upper bound (confirmed_size + batches_since_sync * batch) and
only forces a sync when that bound approaches max_load, growing the table
before an overflow can happen. Growth doubles capacity and re-inserts live
entries (the Java map doubles a stripe under lock at load 0.75,
Long2ShortHashMap:191-214, LongHashSet:28,58 -- same resulting content).

Semantic contract preserved from the reference:
- count saturates at Short.MAX_VALUE = 32767 (itmo:utils/NumUtils.java:21-26);
  we accumulate in int32 and clamp on read, equivalent for +1 increments
- lookup of an absent key returns -1 (Long2ShortHashMap.get:159-175);
  getWithZero -> 0 (:177-183)
- EMPTY sentinel: int64 max (the Java map reserves key 0 as FREE,
  itmo:structures/set/LongHashSet.java:33; int64-max cannot collide with exact
  2-bit keys which are < 2^62, and collides with a 64-bit hash key only with
  probability 2^-64 -- documented divergence, strictly safer than reserving 0)
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .kmers import SENTINEL, canonical_kmers

EMPTY = SENTINEL
SATURATION = 32767  # Short.MAX_VALUE (itmo:utils/NumUtils.java:21-26)


def _mix64(x: jax.Array) -> jax.Array:
    """splitmix64 finalizer over uint64 for probe-start distribution.

    Internal layout detail with no Java counterpart (the reference stripes by
    murmurHash3 of the low word, BigLong2ShortHashMap.java:63-89); any mix works.
    """
    x = x.astype(jnp.uint64)
    x = (x ^ (x >> jnp.uint64(30))) * jnp.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> jnp.uint64(27))) * jnp.uint64(0x94D049BB133111EB)
    x = x ^ (x >> jnp.uint64(31))
    return x


MAX_PROBE_ROUNDS = 128  # load <= max_load keeps linear-probe runs far below this


def _insert_unique_impl(tkeys, tcnts, bkeys, bcnts):
    """Insert a batch of UNIQUE keys (SENTINEL = skip) with counts.

    Empty-slot election: all claimants scatter their key, then read the slot
    back -- exactly one lane observes its own key and wins. Which lane wins is
    implementation-defined (XLA duplicate-index scatter), but the MAP CONTENT
    is identical either way (keys are unique; losers simply probe on), so the
    result is content-deterministic. This avoids the O(capacity) per-round
    temporary a scatter-min election would need.

    Returns (tkeys, tcnts, n_inserted_new:int32, residual:bool[batch]) -- all
    device. `residual` marks lanes whose key did NOT land (table full or probe
    bound hit); callers either assert none (jnp.any) or retain those lanes.
    """
    C = tkeys.shape[0]
    cmask = jnp.uint64(C - 1)
    active0 = bkeys != EMPTY
    slot0 = (_mix64(bkeys) & cmask).astype(jnp.int32)

    def cond(state):
        _, _, active, _, rounds, _ = state
        return jnp.logical_and(jnp.any(active), rounds < MAX_PROBE_ROUNDS)

    def body(state):
        tkeys, tcnts, active, slot, rounds, new = state
        cur = tkeys[slot]
        match = jnp.logical_and(active, cur == bkeys)
        empty = jnp.logical_and(active, cur == EMPTY)
        # claim: scatter keys into empty slots, read back to see who won
        claim_slot = jnp.where(empty, slot, C)  # C = out-of-range -> dropped
        tkeys = tkeys.at[claim_slot].set(bkeys, mode="drop")
        winner = jnp.logical_and(empty, tkeys[slot] == bkeys)
        add_slot = jnp.where(jnp.logical_or(match, winner), slot, C)
        tcnts = tcnts.at[add_slot].add(bcnts, mode="drop")
        done = jnp.logical_or(match, winner)
        active = jnp.logical_and(active, jnp.logical_not(done))
        slot = jnp.where(active, (slot + 1) & jnp.int32(C - 1), slot)
        return (tkeys, tcnts, active, slot, rounds + 1,
                new + jnp.sum(winner).astype(jnp.int32))

    tkeys, tcnts, active, _, _, new = jax.lax.while_loop(
        cond, body, (tkeys, tcnts, active0, slot0, jnp.int32(0), jnp.int32(0)))
    return tkeys, tcnts, new, active


_insert_unique_kernel = jax.jit(_insert_unique_impl, donate_argnums=(0, 1))


@functools.partial(jax.jit)
def _lookup_kernel(tkeys: jax.Array, tcnts: jax.Array, qkeys: jax.Array):
    """Probe counts for query keys. Absent -> -1 (Long2ShortHashMap.get:159-175).
    SENTINEL queries -> -1."""
    C = tkeys.shape[0]
    cmask = jnp.uint64(C - 1)
    slot0 = (_mix64(qkeys) & cmask).astype(jnp.int32)
    active0 = qkeys != EMPTY
    res0 = jnp.full(qkeys.shape, -1, jnp.int32)

    def cond(state):
        active, _, _, rounds = state
        return jnp.logical_and(jnp.any(active), rounds < C)

    def body(state):
        active, slot, res, rounds = state
        cur = tkeys[slot]
        match = jnp.logical_and(active, cur == qkeys)
        res = jnp.where(match, jnp.minimum(tcnts[slot], SATURATION), res)
        miss = jnp.logical_and(active, cur == EMPTY)
        active = jnp.logical_and(active, jnp.logical_not(jnp.logical_or(match, miss)))
        slot = jnp.where(active, (slot + 1) & jnp.int32(C - 1), slot)
        return active, slot, res, rounds + 1

    _, _, res, _ = jax.lax.while_loop(cond, body, (active0, slot0, res0, jnp.int32(0)))
    return res


def _batch_unique_impl(keys_flat: jax.Array):
    """Sort + run-length-encode a flat key batch -> (unique_keys, counts), both
    the same length with SENTINEL/0 padding; padded lanes never count.

    Scatter-free: one sort, a cumsum, a cummax, and one gather. Unique keys
    are emitted IN PLACE at each run's last position (not compacted) -- every
    consumer (_insert_unique_impl, sharded _bucket_by_owner) is
    position-agnostic over SENTINEL-padded lanes, and no scatter (the
    lowering of segment_sum/segment_max) is needed."""
    n = keys_flat.shape[0]
    s = jnp.sort(keys_flat)
    first = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    last = jnp.concatenate([first[1:], jnp.ones((1,), bool)])
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    # run-start index propagated forward by a max-scan over head positions;
    # SENTINEL sorts last, so every non-SENTINEL run has weight = its length
    # and counts come from positions alone (no weight cumsum needed)
    start = jax.lax.associative_scan(jnp.maximum, jnp.where(first, idx, 0))
    real = last & (s != SENTINEL)
    ukeys = jnp.where(real, s, SENTINEL)
    counts = jnp.where(real, idx - start + 1, 0).astype(jnp.int32)
    return ukeys, counts


_batch_unique_counts = jax.jit(_batch_unique_impl)


@functools.partial(jax.jit, static_argnames=("k", "hasher"), donate_argnums=(0, 1))
def _count_insert_kernel(tkeys, tcnts, codes, k: int, hasher: str | None):
    """Fused per-batch pipeline: extract canonical keys -> dedup -> insert.
    One device dispatch per read batch; no host syncs."""
    keys, _ = canonical_kmers(codes, k, hasher)
    ukeys, ucnts = _batch_unique_impl(keys.ravel())
    return _insert_unique_impl(tkeys, tcnts, ukeys, ucnts)


class DeviceHashTable:
    """Device-resident key->count map with host-driven, sync-avoiding growth."""

    def __init__(self, capacity_log2: int = 16, max_load: float = 0.65):
        self.capacity = 1 << capacity_log2
        self.max_load = max_load
        self.tkeys = jnp.full((self.capacity,), EMPTY, jnp.int64)
        self.tcnts = jnp.zeros((self.capacity,), jnp.int32)
        self._size_dev = jnp.int32(0)   # lazy device-side accumulator
        self._size_confirmed = 0        # value of _size_dev at last sync
        self._pending_bound = 0         # upper bound on new keys since sync
        self._overflow_flags: list[jax.Array] = []

    @classmethod
    def from_kmer_map(cls, kmap) -> "DeviceHashTable":
        """One-shot build of a read-only device table from a KmerMap."""
        import numpy as np
        n = max(len(kmap), 1)
        # load 0.25: probe rounds (random gathers) are the dominant BFS
        # layer cost; halving the load nearly halves the while_loop's
        # worst-lane round count
        cap_log2 = max(int(np.ceil(np.log2(n / 0.25 + 1))), 4)
        table = cls(capacity_log2=cap_log2)
        pad = 1 << int(np.ceil(np.log2(n + 1)))
        bk = np.full(pad, EMPTY, np.int64)
        bc = np.zeros(pad, np.int32)
        bk[: len(kmap)] = kmap.keys
        bc[: len(kmap)] = kmap.counts
        table.tkeys, table.tcnts, new, resid = _insert_unique_kernel(
            table.tkeys, table.tcnts, jnp.asarray(bk), jnp.asarray(bc))
        assert not bool(jnp.any(resid))
        table._size_dev = new.astype(jnp.int32)
        table._size_confirmed = len(kmap)
        return table

    # -- size bookkeeping ---------------------------------------------------
    @property
    def size(self) -> int:
        """Exact live-entry count (forces a sync)."""
        self._sync()
        return self._size_confirmed

    def _sync(self) -> None:
        self._size_confirmed = int(self._size_dev)
        self._pending_bound = 0
        if self._overflow_flags:
            if any(bool(f) for f in self._overflow_flags):  # pragma: no cover
                raise RuntimeError("hash table overflow despite growth guard")
            self._overflow_flags.clear()

    def _ensure_room(self, incoming: int) -> None:
        bound = self._size_confirmed + self._pending_bound + incoming
        if bound <= self.capacity * self.max_load:
            return
        self._sync()
        while self._size_confirmed + incoming > self.capacity * self.max_load:
            self._grow()

    def _grow(self) -> None:
        old_keys, old_cnts = self.tkeys, self.tcnts
        self.capacity *= 2
        self.tkeys = jnp.full((self.capacity,), EMPTY, jnp.int64)
        self.tcnts = jnp.zeros((self.capacity,), jnp.int32)
        self.tkeys, self.tcnts, new, resid = _insert_unique_kernel(
            self.tkeys, self.tcnts, old_keys, old_cnts)
        self._size_dev = new.astype(jnp.int32)
        self._size_confirmed = int(new)
        self._pending_bound = 0
        assert not bool(jnp.any(resid))

    # -- hot path -----------------------------------------------------------
    def count_insert_codes(self, codes: jax.Array, k: int, hasher: str | None) -> None:
        """Fused: extract canonical k-mers of a (B, L) code batch and count them."""
        bound = codes.shape[0] * codes.shape[1]
        self._ensure_room(bound)
        self.tkeys, self.tcnts, new, resid = _count_insert_kernel(
            self.tkeys, self.tcnts, codes, k, hasher)
        self._size_dev = self._size_dev + new
        self._pending_bound += bound
        self._overflow_flags.append(jnp.any(resid))

    def insert_batch(self, keys: jax.Array) -> None:
        """Count-insert a (possibly duplicated, SENTINEL-padded) key batch."""
        flat = keys.ravel()
        self._ensure_room(flat.shape[0])
        ukeys, ucnts = _batch_unique_counts(flat)
        self.tkeys, self.tcnts, new, resid = _insert_unique_kernel(
            self.tkeys, self.tcnts, ukeys, ucnts)
        self._size_dev = self._size_dev + new
        self._pending_bound += flat.shape[0]
        self._overflow_flags.append(jnp.any(resid))

    def lookup(self, keys: jax.Array) -> jax.Array:
        """Counts for keys; absent/SENTINEL -> -1. Counts clamp at 32767."""
        return _lookup_kernel(self.tkeys, self.tcnts, keys)

    # -- extraction ---------------------------------------------------------
    def items_device(self) -> tuple[jax.Array, jax.Array]:
        """Compacted key-sorted (keys, counts); padded with SENTINEL/0 to
        table capacity (single device sort, no dynamic shapes)."""
        return _compact_kernel(self.tkeys, self.tcnts)

    def items_host(self) -> tuple[np.ndarray, np.ndarray]:
        """All (key, count) pairs, key-sorted, counts clamped at 32767."""
        n = self.size
        dk, dc = self.items_device()
        k = np.asarray(dk[:n])
        c = np.asarray(dc[:n])
        return k, np.minimum(c, SATURATION).astype(np.int32)


@functools.partial(jax.jit)
def _compact_kernel(tkeys, tcnts):
    order = jnp.argsort(tkeys)  # EMPTY = int64 max sorts last
    return tkeys[order], tcnts[order]
