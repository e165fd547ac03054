"""Multi-device k-mer counting: DP over reads x hash-sharded table, all-to-all.

Replacement for the reference's only "distributed" mechanism -- a
shared-memory striped hash map fed by a thread pool (SURVEY §2.3 P1/P2,
itmo:structures/map/BigLong2ShortHashMap.java:63-89). Design:

- 1D device mesh axis "d": every device is BOTH a reads worker (the read batch
  is sharded over "d") and the owner of one table shard (keys are owned by
  device mix64(key) mod n).
- per step (shard_map over "d"):
    1. extract canonical keys from the local batch shard (fused scan)
    2. local dedup (sort + segment-sum) -- shrinks the wire volume to the
       number of DISTINCT local keys
    3. bucket unique keys by owner and all_to_all between the devices
    4. insert received (key, count) pairs into the local table shard
- deterministic by construction: insertion order within a shard never affects
  the resulting map contents (counts are commutative sums; slot election is
  only a layout detail).

The all_to_all uses fixed per-destination capacity cap = ceil(local_unique /
n) * SLACK; keys overflowing a bucket are RETAINED locally in an overflow
buffer that is re-sent on the next step (never dropped), so correctness does
not depend on the slack factor. With a well-mixed hash, bucket sizes
concentrate tightly around the mean, so SLACK=2 practically never overflows.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.kmers import canonical_kmers, SENTINEL
from ..ops.hashtable import _mix64, _insert_unique_impl, _batch_unique_impl
from ..ops.sortcount import _rle_sorted


def make_mesh(devices=None, axis: str = "d") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def _bucket_by_owner(keys: jax.Array, counts: jax.Array, n: int, cap: int):
    """Pack (keys, counts) into (n, cap) per-destination buckets + overflow mask.

    Keys are assigned rank-within-bucket by sorting on owner; entries whose
    rank >= cap are flagged as overflow (kept, re-sent later)."""
    owner = (_mix64(keys) % jnp.uint64(n)).astype(jnp.int32)
    owner = jnp.where(keys == SENTINEL, n, owner)  # sentinels -> virtual bucket
    order = jnp.argsort(owner, stable=True)
    so, sk, sc = owner[order], keys[order], counts[order]
    # rank within each owner group
    idx = jnp.arange(so.shape[0], dtype=jnp.int32)
    first_of_group = jnp.concatenate(
        [jnp.zeros((1,), bool), so[1:] != so[:-1]])
    group_start = jnp.where(first_of_group, idx, 0)
    group_start = jax.lax.associative_scan(jnp.maximum, group_start)
    rank = idx - group_start
    ok = (rank < cap) & (so < n)
    dest = jnp.where(ok, so * cap + rank, n * cap)
    bk = jnp.full((n * cap + 1,), SENTINEL, jnp.int64).at[dest].set(
        sk, mode="drop")[: n * cap]
    bc = jnp.zeros((n * cap + 1,), jnp.int32).at[dest].set(
        sc, mode="drop")[: n * cap]
    ov_keys = jnp.where(ok | (so >= n), SENTINEL, sk)
    ov_cnts = jnp.where(ok | (so >= n), 0, sc)
    return bk.reshape(n, cap), bc.reshape(n, cap), ov_keys, ov_cnts


def make_sharded_count_step(mesh: Mesh, k: int, hasher: str | None,
                            slack: int = 2):
    """Returns step(tkeys, tcnts, ov_keys, ov_cnts, codes) -> same tuple.

    tkeys/tcnts: per-device table shards, sharded over axis "d" (dim 0).
    ov_keys/ov_cnts: per-device overflow carry, sharded over "d".
    codes: (B, L) read batch, B sharded over "d".
    """
    axis = mesh.axis_names[0]
    n = mesh.devices.size

    def local_step(tkeys, tcnts, ov_keys, ov_cnts, codes):
        # shard_map gives blocks with a leading singleton shard dim
        tkeys, tcnts = tkeys[0], tcnts[0]
        ov_keys, ov_cnts = ov_keys[0], ov_cnts[0]
        keys, _ = canonical_kmers(codes, k, hasher)
        flat = jnp.concatenate([keys.ravel(), ov_keys])
        cnts = jnp.concatenate(
            [jnp.ones(keys.size, jnp.int32), ov_cnts])
        # local dedup with counts (overflow carries weights > 1)
        ukeys, ucnts = _weighted_unique(flat, cnts)
        cap = -(-ukeys.shape[0] // n) * slack
        bk, bc, ovk, ovc = _bucket_by_owner(ukeys, ucnts, n, cap)
        rk = jax.lax.all_to_all(bk, axis, split_axis=0, concat_axis=0,
                                tiled=True)
        rc = jax.lax.all_to_all(bc, axis, split_axis=0, concat_axis=0,
                                tiled=True)
        ruk, ruc = _weighted_unique(rk.ravel(), rc.ravel())
        tkeys, tcnts, new, resid = _insert_unique_impl(
            tkeys, tcnts, ruk, ruc)
        # keys that failed to land (shard full / probe bound) are RETAINED:
        # merged into the overflow carry and re-sent after the host grows the
        # table -- the count multiset is never silently truncated
        resid_k = jnp.where(resid, ruk, SENTINEL)
        resid_c = jnp.where(resid, ruc, 0)
        table_ovf = jnp.any(resid)
        # compact overflow carry (+ residuals) to a fixed small buffer
        m = ov_keys.shape[0]
        all_ovk = jnp.concatenate([ovk, resid_k])
        all_ovc = jnp.concatenate([ovc, resid_c])
        ovk2, ovc2, n_ov = _rle_sorted(
            all_ovk, jnp.where(all_ovk == SENTINEL, 0, all_ovc), m)
        carry_ovf = n_ov > m  # distinct carry exceeded the buffer: data loss
        return (tkeys[None], tcnts[None], ovk2[None], ovc2[None],
                new[None], table_ovf[None], carry_ovf[None])

    spec = P(axis)
    return jax.jit(shard_map(
        local_step, mesh=mesh,
        in_specs=(spec, spec, spec, spec, P(axis, None)),
        out_specs=(spec, spec, spec, spec, spec, spec, spec),
        check_vma=False,
    ), donate_argnums=(0, 1, 2, 3))


def make_grow_step(mesh: Mesh):
    """Returns grow(tkeys, tcnts) -> (tkeys2x, tcnts2x, sizes).

    Doubles every shard's capacity and re-inserts its live entries locally
    (the owner assignment mix64(key) % n is capacity-independent, so entries
    never change shards). Counterpart of the Java map's per-stripe doubling
    (itmo:structures/map/Long2ShortHashMap.java:191-214) for the sharded table.
    """
    axis = mesh.axis_names[0]

    def local_grow(tkeys, tcnts):
        tkeys, tcnts = tkeys[0], tcnts[0]
        C = tkeys.shape[0]
        nk = jnp.full((2 * C,), SENTINEL, jnp.int64)
        nc = jnp.zeros((2 * C,), jnp.int32)
        nk, nc, new, ovf = _insert_unique_impl(nk, nc, tkeys, tcnts)
        return nk[None], nc[None], new[None]

    spec = P(axis)
    return jax.jit(shard_map(
        local_grow, mesh=mesh,
        in_specs=(spec, spec), out_specs=(spec, spec, spec),
        check_vma=False,
    ))


def _weighted_unique(keys: jax.Array, counts: jax.Array):
    """Sort keys, sum counts per distinct key; padded with SENTINEL/0.
    Scatter-free RLE (see ops/sortcount._rle_sorted)."""
    from ..ops.sortcount import _rle_sorted
    w = jnp.where(keys == SENTINEL, 0, counts).astype(jnp.int32)
    ukeys, ucnts, _ = _rle_sorted(keys, w, keys.shape[0])
    return ukeys, ucnts


class ShardedCounter:
    """Multi-device streaming counter facade.

    Overflow discipline (no key is ever silently lost):
    - shard-table overflow: residual keys are retained in the per-device carry
      buffer; the host grows all shards (x2, shard-local re-insert) and the
      carry re-sends them. Growth is triggered proactively by a sound host
      bound (confirmed max shard size + keys appended since the last sync) and
      reactively by the per-step table_ovf flag.
    - carry-buffer overflow (distinct carried keys exceed the fixed buffer,
      possible only under adversarial bucket skew): detected by the per-step
      carry_ovf flag -> hard RuntimeError at the next sync. Counterpart of the
      reference's lock-protected stripe growth
      (itmo:structures/map/Long2ShortHashMap.java:191-214).
    """

    def __init__(self, mesh: Mesh, k: int, hasher: str | None = None,
                 capacity_log2_per_shard: int = 16, batch: int = 1024,
                 max_len: int = 256, overflow_buf: int = 4096,
                 max_load: float = 0.65):
        self.mesh = mesh
        self.k = k
        self.hasher = hasher
        self.n = mesh.devices.size
        self.batch = batch
        self.max_len = max_len
        self.max_load = max_load
        self.shard_cap = 1 << capacity_log2_per_shard
        axis = mesh.axis_names[0]
        self.sharding = jax.NamedSharding(mesh, P(axis))
        self.batch_sharding = jax.NamedSharding(mesh, P(axis, None))
        self.tkeys = jax.device_put(
            jnp.full((self.n, self.shard_cap), SENTINEL, jnp.int64),
            self.sharding)
        self.tcnts = jax.device_put(
            jnp.zeros((self.n, self.shard_cap), jnp.int32), self.sharding)
        self.ov_keys = jax.device_put(
            jnp.full((self.n, overflow_buf), SENTINEL, jnp.int64), self.sharding)
        self.ov_cnts = jax.device_put(
            jnp.zeros((self.n, overflow_buf), jnp.int32), self.sharding)
        self.step = make_sharded_count_step(mesh, k, hasher)
        self.grow_step = make_grow_step(mesh)
        # per-shard inserted-count accumulator (device, sharded) + host bound
        self._sizes_dev = jax.device_put(
            jnp.zeros((self.n,), jnp.int32), self.sharding)
        self._max_confirmed = 0   # max shard size at last sync
        self._pending = 0         # upper bound on keys appended since sync
        self._table_flags: list[jax.Array] = []
        self._carry_flags: list[jax.Array] = []

    def _sync(self) -> None:
        """Read back per-shard sizes + flags; grow/raise as needed."""
        sizes = np.asarray(self._sizes_dev)
        self._max_confirmed = int(sizes.max()) if sizes.size else 0
        self._pending = 0
        table_ovf = any(bool(jnp.any(f)) for f in self._table_flags)
        carry_ovf = any(bool(jnp.any(f)) for f in self._carry_flags)
        self._table_flags.clear()
        self._carry_flags.clear()
        if carry_ovf:
            raise RuntimeError(
                "sharded counter: overflow-carry buffer exceeded "
                "(adversarial bucket skew); raise overflow_buf")
        if table_ovf:
            self._grow()

    def _grow(self) -> None:
        self.tkeys, self.tcnts, sizes = self.grow_step(self.tkeys, self.tcnts)
        self.shard_cap *= 2
        self._sizes_dev = sizes
        s = np.asarray(sizes)
        self._max_confirmed = int(s.max()) if s.size else 0
        self._pending = 0

    def _ensure_room(self, incoming: int) -> None:
        if (self._max_confirmed + self._pending + incoming
                <= self.shard_cap * self.max_load):
            return
        self._sync()
        while (self._max_confirmed + incoming
               > self.shard_cap * self.max_load):
            self._grow()

    def add_codes(self, codes: np.ndarray) -> None:
        """codes: (B, L) int32 with B divisible by n."""
        B, L = int(codes.shape[0]), int(codes.shape[1])
        # Growth estimate: each device contributes <= windows-per-row
        # (L-k+1, not L) distinct keys + its carry; with a well-mixed owner
        # hash a shard receives ~1/n of every device's keys, i.e. `local`
        # keys in expectation, with O(sqrt) concentration. Deliberately the
        # expectation (not the n*bucket_cap worst case): an underestimate
        # only trips the reactive table_ovf flag -- residuals are retained
        # in the carry and re-sent after the sync-triggered grow -- so this
        # bound tunes _sync frequency, never correctness.
        windows = max(L - self.k + 1, 0)
        local = (B // self.n) * windows + self.ov_keys.shape[1]
        incoming = local + 4 * int(local ** 0.5) + 64  # skew margin
        self._ensure_room(incoming)
        dev = jax.device_put(jnp.asarray(codes), self.batch_sharding)
        (self.tkeys, self.tcnts, self.ov_keys, self.ov_cnts,
         new, tf, cf) = self.step(
            self.tkeys, self.tcnts, self.ov_keys, self.ov_cnts, dev)
        self._sizes_dev = self._sizes_dev + new
        self._pending += incoming
        self._table_flags.append(tf)
        self._carry_flags.append(cf)

    def drain(self) -> None:
        """Flush any overflow carry with empty batches until clean.

        Progress-bounded (not a fixed iteration cap): every pass either
        shrinks the live carry or triggers a grow via the table_ovf flag
        (capacity doubles, so the next pass must land its keys). Two
        consecutive passes with no shrink and no grow -> hard error.
        """
        empty = np.full((self.n, self.max_len), -1, np.int32)
        prev_live = None
        stalls = 0
        while True:
            cap_before = self.shard_cap
            self._sync()  # grows if any residuals were flagged
            live = int(jnp.sum(self.ov_keys != SENTINEL))
            if live == 0:
                return
            progressed = (prev_live is None or live < prev_live
                          or self.shard_cap > cap_before)
            stalls = 0 if progressed else stalls + 1
            if stalls >= 2:
                raise RuntimeError(
                    f"overflow carry failed to drain (stuck at {live} keys)")
            prev_live = live
            self.add_codes(empty)

    def items_host(self) -> tuple[np.ndarray, np.ndarray]:
        self.drain()
        tk = np.asarray(self.tkeys).ravel()
        tc = np.asarray(self.tcnts).ravel()
        live = tk != SENTINEL
        keys, cnts = tk[live], tc[live]
        order = np.argsort(keys, kind="stable")
        return keys[order], np.minimum(cnts[order], 32767)
