"""Sort-based streaming k-mer counter: the default counting hot path.

Random-access probing (open addressing) pays data-dependent while_loop rounds;
this counter uses only contiguous writes and bulk sorts instead:

  hot path:   extract canonical keys -> append into a device ring buffer
              (dynamic_update_slice: contiguous, no collisions, no loops)
  consolidate (buffer full): ONE sort + run-length-encode of the whole buffer,
              merged with the running (keys, counts) store by concat + sort +
              segment-sum -- all fixed-shape, loop-free ops
  finalize:   last consolidation; counts clamp at 32767
              (itmo:utils/NumUtils.java:21-26)

Lookups afterwards are vectorized binary searches on the sorted store
(kmer_map.KmerMap) -- pure gathers, no probing.

Capacity model: the append buffer holds `buffer_cap` raw keys; the store holds
up to `store_cap` distinct (key, count) pairs, growing by doubling when a
consolidation overflows it. All shapes are static per (buffer_cap, store_cap)
pair, so recompiles happen O(log growth) times.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .kmers import SENTINEL, window_keys


@functools.partial(jax.jit, static_argnames=("k", "hasher"), donate_argnums=(0,))
def _append_kernel(buf, offset, codes, k: int, hasher: str | None):
    """Extract keys from a (B, L) code batch and append at buf[offset:].

    The first k-1 key columns of every row are ALWAYS invalid (window j
    covers [j-k+1, j]) and are left out of the append -- at L=256, k=31
    that is ~12% of the lanes every consolidation would otherwise sort as
    SENTINEL padding. Remaining invalid positions (N-splits, short rows)
    still append SENTINEL (cheap: sorts to the end and is dropped by
    consolidation). Returns (buf, new_offset)."""
    flat = window_keys(codes, k, hasher)
    buf = jax.lax.dynamic_update_slice(buf, flat, (offset,))
    return buf, offset + flat.shape[0]


def _rle_sorted(all_keys, all_w, m):
    """Gather-free run-length-encode of a key/weight multiset.

    The RLE uses only sorts and scans, no scatter and no random gather: a
    two-operand key sort carries the weights along (no argsort + gather);
    per-run weight totals come from a segmented-sum associative scan that
    resets at run heads (no prefix-sum gathers); run heads are compacted by
    a second two-operand sort that pushes non-heads (rekeyed to SENTINEL) to
    the back. Returns (keys[:m], cnts[:m], n_distinct)."""
    s, w = jax.lax.sort((all_keys, all_w.astype(jnp.int64)), num_keys=1)
    first = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    last = jnp.concatenate([first[1:], jnp.ones((1,), bool)])

    # segmented inclusive sum of w, resetting at run heads: classic
    # (flag, sum) semigroup
    def seg_add(a, b):
        af, asum = a
        bf, bsum = b
        return af | bf, jnp.where(bf, bsum, asum + bsum)

    _, run_sum = jax.lax.associative_scan(seg_add, (first, w))
    # compact run LASTS (which carry the full run total) via one more sort
    real = last & (s != SENTINEL)
    key2 = jnp.where(real, s, SENTINEL)
    sum2 = jnp.where(real, run_sum, 0)
    keys_c, sums_c = jax.lax.sort((key2, sum2), num_keys=1)
    keys_c = jnp.where(sums_c > 0, keys_c, SENTINEL)
    # clamp far above the 32767 output saturation so repeated consolidations
    # cannot overflow int32 while preserving min(total, 32767) semantics
    sums_c = jnp.minimum(sums_c, 1_000_000_000)
    cnts_c = jnp.where(keys_c == SENTINEL, 0, sums_c).astype(jnp.int32)
    n_distinct = jnp.sum(keys_c != SENTINEL).astype(jnp.int32)
    return keys_c[:m], cnts_c[:m], n_distinct


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _consolidate_kernel(store_keys, store_cnts, buf, offset):
    """Merge the append buffer into the sorted store.

    Pads un-appended buffer tail with SENTINEL, concatenates store + buffer,
    and run-length-encodes (store entries carry their counts, buffer entries
    weight 1, SENTINEL weight 0) back into the store shape.
    Returns (store_keys, store_cnts, n_distinct, overflowed).
    """
    n = buf.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    buf = jnp.where(lane < offset, buf, SENTINEL)
    all_keys = jnp.concatenate([store_keys, buf])
    all_w = jnp.concatenate(
        [store_cnts, jnp.ones((n,), jnp.int32)])
    all_w = jnp.where(all_keys == SENTINEL, 0, all_w)
    m = store_keys.shape[0]
    keys, cnts, n_distinct = _rle_sorted(all_keys, all_w, m)
    return keys, cnts, n_distinct, n_distinct > m


# --- split consolidation: the same algorithm as _consolidate_full_kernel,
# but each stage is its OWN jit unit: prep, a bare two-operand sort, a plain
# cumsum marking pass, the same sort again for compaction, and a diff. Both
# sorts share one compiled unit, and XLA loses no useful fusion: the sorts
# dominate and cannot fuse with their neighbors anyway.

@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _prep_kernel(store_keys, store_cnts, buf, offset):
    """Concat store + masked buffer into one (keys, weights) multiset.

    Weights are int64 so that both sorts of the split pipeline (keys with
    weights, then keys with prefix sums) share one (int64, int64) compiled
    unit. (The merge-split path carries its own int32 weights and int64
    prefix sums instead.)"""
    n = buf.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    buf = jnp.where(lane < offset, buf, SENTINEL)
    all_keys = jnp.concatenate([store_keys, buf])
    all_w = jnp.concatenate([store_cnts, jnp.ones((n,), jnp.int32)])
    all_w = jnp.where(all_keys == SENTINEL, 0, all_w).astype(jnp.int64)
    return all_keys, all_w


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _sort2_kernel(keys, w):
    """Bare two-operand sort: keys ascending, weights carried along."""
    return jax.lax.sort((keys, w), num_keys=1)


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _rle_mark_kernel(s, w):
    """Mark run lasts of a SORTED multiset with the run total; rekey the rest
    to SENTINEL (weight 0). Scan + elementwise only -- no sort in this unit.

    Semantics oracle for tests: _cumsum_mark_kernel below computes the same
    result from a plain jnp.cumsum instead of the (flag, sum) custom-semigroup
    associative scan, and is what _consolidate_full_split dispatches."""
    first = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    last = jnp.concatenate([first[1:], jnp.ones((1,), bool)])

    def seg_add(a, b):
        af, asum = a
        bf, bsum = b
        return af | bf, jnp.where(bf, bsum, asum + bsum)

    _, run_sum = jax.lax.associative_scan(seg_add, (first, w))
    real = last & (s != SENTINEL)
    key2 = jnp.where(real, s, SENTINEL)
    sum2 = jnp.where(real, run_sum, 0)
    return key2, sum2


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _cumsum_mark_kernel(s, w):
    """Run totals WITHOUT a segmented scan: plain inclusive cumsum of weights.

    At each run-LAST lane the cumsum equals the total weight through that
    run; after the compaction sort (order-preserving for the strictly
    ascending surviving keys) each run's count is the adjacent difference of
    the compacted cumsum values (_diff_finish_kernel). SENTINEL/masked lanes
    carry weight 0, so they never perturb the prefix sums. Returns
    (key2, pref2): run-last lanes keep (key, cumsum), all others
    (SENTINEL, 0)."""
    pc = jnp.cumsum(w.astype(jnp.int64))
    last = jnp.concatenate([s[1:] != s[:-1], jnp.ones((1,), bool)])
    real = last & (s != SENTINEL)
    key2 = jnp.where(real, s, SENTINEL)
    pref2 = jnp.where(real, pc, 0)
    return key2, pref2


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _rle_finish_kernel(keys_c, sums_c):
    """Post-compaction cleanup: drop zero-weight lanes, clamp, count."""
    keys_c = jnp.where(sums_c > 0, keys_c, SENTINEL)
    sums_c = jnp.minimum(sums_c, 1_000_000_000)
    cnts_c = jnp.where(keys_c == SENTINEL, 0, sums_c).astype(jnp.int32)
    n_distinct = jnp.sum(keys_c != SENTINEL).astype(jnp.int32)
    return keys_c, cnts_c, n_distinct


def _consolidate_full_split(store_keys, store_cnts, buf, offset):
    """_consolidate_full_kernel semantics via 5 small-jit dispatches:
    prep -> sort2 -> cumsum_mark -> sort2 (compaction) -> diff_finish.

    Both sort2 calls share ONE compiled unit (identical (int64, int64)
    signatures); everything else is elementwise + one native cumsum, so the
    only expensive unit per geometry is the bare two-operand sort.

    MC_SORT_COMPACTION=shift swaps the SECOND full sort (which only
    compacts run-lasts to the front; the survivors are already in key
    order) for the merge path's binary-decomposed shift stages --
    elementwise selects instead of a true sort. Equality-pinned in the
    tests. Requires a power-of-two total; any other total uses sort2."""
    all_keys, all_w = _prep_kernel(store_keys, store_cnts, buf, offset)
    s, w = _sort2_kernel(all_keys, all_w)
    import os
    n = all_keys.shape[0]
    if (os.environ.get("MC_SORT_COMPACTION") == "shift"
            and (n & (n - 1)) == 0):
        return _shift_compact(s, w)
    key2, pref2 = _cumsum_mark_kernel(s, w)
    keys_c, prefs_c = _sort2_kernel(key2, pref2)
    return _diff_finish_kernel(keys_c, prefs_c)


def _shift_compact(keys, w):
    """Run-last marking + binary-decomposed shift compaction of a SORTED
    multiset (the merge path's tail, shared with the sort2 path's optional
    MC_SORT_COMPACTION=shift mode). Requires a power-of-two lane count."""
    key2, pref2, d = _prefix_mark_kernel(keys, w)
    key2, pref2 = _shift_stages_kernel(key2, pref2, d)
    return _diff_finish_kernel(key2, pref2)


# --- merge-split consolidation: no full-width sort, no segmented scan.
#
# The split pipeline above pays two TRUE sorts over buffer+store lanes. This
# pipeline exploits that the STORE IS ALREADY SORTED, so the only true sort
# needed is of the buffer alone (keys only, 1-operand); everything wider is
# static-stride elementwise work:
#
#   buffer sort (1-op lax.sort)
#   bitonic half-clean merge stages (one jit unit)
#   plain jnp.cumsum (int64)
#   shift-compaction stages (one jit unit)
#
# It is StreamCounter's default: on the card it beat the sort2 pipeline at
# every total measured, 2^20 to 2^28 lanes, by about 3x from 2^24 up, and
# all stages in one unit ran as fast as or faster than four per unit
# (scripts/profile_consolidate.py).
#
# Run totals WITHOUT a segmented scan: take the plain inclusive cumsum of
# weights over the merged sorted multiset; at each run-LAST lane the cumsum
# equals the total weight through that run; after compacting the run-lasts
# (order-preserving), each run's count is the adjacent difference of
# compacted cumsum values.  SENTINEL lanes carry weight 0, so they never
# perturb the prefix sums.

@functools.partial(jax.jit, static_argnames=("pad",), donate_argnums=(2,))
def _merge_prep_kernel(store_keys, store_cnts, sorted_buf, pad: int):
    """Bitonic pre-arrangement: store ascending ++ reversed sorted buffer.

    Store counts clamp at 1e9 (as everywhere); buffer lanes weigh 1
    (SENTINEL 0). `pad` SENTINEL lanes extend the buffer side so the total
    is a power of two (SENTINEL = int64 max: the ascending/plateau/descending
    shape stays bitonic)."""
    sw = jnp.where(store_keys == SENTINEL, 0,
                   jnp.minimum(store_cnts, 1_000_000_000)).astype(jnp.int32)
    bw = jnp.where(sorted_buf == SENTINEL, 0, 1).astype(jnp.int32)
    if pad:
        sorted_buf = jnp.concatenate(
            [sorted_buf, jnp.full((pad,), SENTINEL, jnp.int64)])
        bw = jnp.concatenate([bw, jnp.zeros((pad,), jnp.int32)])
    keys = jnp.concatenate([store_keys, sorted_buf[::-1]])
    w = jnp.concatenate([sw, bw[::-1]])
    return keys, w


@functools.partial(jax.jit, donate_argnums=(0,))
def _sort_keys_kernel(buf, offset):
    """Mask un-appended tail and sort keys ascending (1-operand sort)."""
    n = buf.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    return jax.lax.sort(jnp.where(lane < offset, buf, SENTINEL))


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _bitonic_merge_kernel(keys, w):
    """All bitonic half-cleaner stages (strides n/2, n/4, ..., 1) of a
    power-of-two bitonic sequence: one jit unit."""
    from .bitonic import _half_clean
    s = keys.shape[0] // 2
    while s >= 1:
        keys, (w,) = _half_clean(keys, [w], s)
        s //= 2
    return keys, w


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _prefix_mark_kernel(keys, w):
    """Inclusive int64 cumsum of weights; keep run-lasts only:
    (key, cumsum) at run-last lanes, (SENTINEL, 0) elsewhere."""
    pc = jnp.cumsum(w.astype(jnp.int64))
    last = jnp.concatenate([keys[1:] != keys[:-1], jnp.ones((1,), bool)])
    real = last & (keys != SENTINEL)
    key2 = jnp.where(real, keys, SENTINEL)
    pref2 = jnp.where(real, pc, 0)
    # monotone displacement for the shift compaction (# holes before lane)
    holes = (~real).astype(jnp.int32)
    d = jnp.cumsum(holes) - holes  # exclusive prefix
    d = jnp.where(real, d, 0)
    return key2, pref2, d


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _shift_stages_kernel(keys, vals, d):
    """All binary-decomposed left-shift compaction stages: one jit unit.

    Same scheme as bitonic.compact_sorted: element at lane i with bit j set
    in its displacement moves left by 2^j; monotone displacement keeps every
    intermediate position distinct, so shifted selects are exact."""
    for j in range((keys.shape[0] - 1).bit_length()):
        s = 1 << j
        moving = ((d >> j) & 1) == 1
        arr_k = jnp.concatenate(
            [keys[s:], jnp.full((s,), SENTINEL, keys.dtype)])
        arr_v = jnp.concatenate([vals[s:], jnp.zeros((s,), vals.dtype)])
        arr_d = jnp.concatenate([d[s:], jnp.zeros((s,), jnp.int32)])
        arrives = jnp.concatenate([moving[s:], jnp.zeros((s,), bool)])
        keys = jnp.where(arrives, arr_k, jnp.where(moving, SENTINEL, keys))
        vals = jnp.where(arrives, arr_v, jnp.where(moving, 0, vals))
        d = jnp.where(arrives, arr_d, jnp.where(moving, 0, d))
    return keys, vals


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _diff_finish_kernel(keys_c, pref_c):
    """Counts from adjacent differences of compacted cumulative sums."""
    prev = jnp.concatenate([jnp.zeros((1,), jnp.int64), pref_c[:-1]])
    cnts = jnp.where(keys_c == SENTINEL, 0, pref_c - prev)
    cnts = jnp.minimum(cnts, 1_000_000_000).astype(jnp.int32)
    n_distinct = jnp.sum(keys_c != SENTINEL).astype(jnp.int32)
    return keys_c, cnts, n_distinct


def _consolidate_merge_split(store_keys, store_cnts, buf, offset):
    """Merge-split consolidation (see block comment above).

    Total lanes are padded up to a power of two on the buffer side. Returns
    (keys, cnts, n_distinct) at full merged length, distinct keys sorted at
    the front -- the same full-result contract as _consolidate_full_split."""
    raw = store_keys.shape[0] + buf.shape[0]
    n = 1 << (raw - 1).bit_length()
    sorted_buf = _sort_keys_kernel(buf, offset)
    keys, w = _merge_prep_kernel(store_keys, store_cnts, sorted_buf, n - raw)
    keys, w = _bitonic_merge_kernel(keys, w)
    return _shift_compact(keys, w)


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _consolidate_full_kernel(store_keys, store_cnts, buf, offset):
    """Merge buffer into store, keeping the FULL (m+n)-lane compacted result.

    Unlike _consolidate_kernel this can never lose keys: the compacted RLE
    output is as long as its input, so every distinct key survives regardless
    of the logical store size. The host decides afterwards (off the returned
    n_distinct, read back lazily) how many lanes the next store view keeps --
    store growth is therefore just "keep more lanes", with no re-insert pass
    and no worst-case pre-growth of the store by the full buffer size.
    """
    n = buf.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    buf = jnp.where(lane < offset, buf, SENTINEL)
    all_keys = jnp.concatenate([store_keys, buf])
    all_w = jnp.concatenate([store_cnts, jnp.ones((n,), jnp.int32)])
    all_w = jnp.where(all_keys == SENTINEL, 0, all_w)
    keys, cnts, n_distinct = _rle_sorted(
        all_keys, all_w, all_keys.shape[0])
    return keys, cnts, n_distinct


class StreamCounter:
    """Device streaming counter with a loop-free, loss-proof hot path.

    The only host<->device sync is ONE deferred scalar readback per
    consolidation (once per buffer_cap raw keys): the n_distinct of
    consolidation i is read back just before consolidation i+1 is dispatched,
    by which point the device computed it long ago -- so the sync pays wire
    latency only, never compute wait. Store growth = "keep more lanes of the
    full compacted result" (see _consolidate_full_kernel); no key can be lost
    and no worst-case pre-growth happens.
    """

    def __init__(self, buffer_cap_log2: int = 24, store_cap_log2: int = 22,
                 buffer_cap: int | None = None, store_cap: int | None = None,
                 mode: str = "merge"):
        # raw lane counts override the log2 forms: consolidation cost scales
        # with buffer_cap + store_cap lanes -- see bench.py GEOMETRY
        self.buffer_cap = buffer_cap if buffer_cap else (1 << buffer_cap_log2)
        self.store_cap = store_cap if store_cap else (1 << store_cap_log2)
        # mode: 'merge' = buffer-only sort + bitonic merge + cumsum + shift
        # compaction (the default, see the merge-split block comment);
        # 'sort2' = two full-width two-operand sorts
        if mode not in ("sort2", "merge"):
            raise ValueError(
                f"mode must be 'sort2' or 'merge'; got {mode!r}")
        self.mode = mode
        self.buf = jnp.full((self.buffer_cap,), SENTINEL, jnp.int64)
        self.offset = jnp.int32(0)
        self._offset_host = 0
        self.store_keys = jnp.full((self.store_cap,), SENTINEL, jnp.int64)
        self.store_cnts = jnp.zeros((self.store_cap,), jnp.int32)
        self._live = 0  # exact live store entries as of the last resolve
        # unresolved consolidation result: (full_keys, full_cnts, n_distinct)
        self._pending = None

    def add_codes(self, codes: jax.Array, k: int, hasher: str | None) -> None:
        width = codes.shape[1] - k + 1  # first k-1 key columns are trimmed
        if width <= 0:
            return  # no window fits: nothing to count
        incoming = codes.shape[0] * width
        if self._offset_host + incoming > self.buffer_cap:
            self._consolidate()
        self.buf, self.offset = _append_kernel(
            self.buf, self.offset, codes, k, hasher)
        self._offset_host += incoming

    def _resolve(self) -> None:
        """Turn the pending full consolidation result into the store view."""
        if self._pending is None:
            return
        fk, fc, nd = self._pending
        self._pending = None
        self._live = int(nd)
        old_total = self.buffer_cap + self.store_cap
        grew = False
        while self._live > self.store_cap:
            self.store_cap *= 2
            grew = True
        if grew:
            # keep buffer+store at the SAME power-of-two total when the
            # grown store fits in half of it (shrinking the buffer), else
            # double the total -- so store growth reuses the one cached
            # consolidation shape instead of shifting ALL
            # subsequent totals to odd sizes. (The consolidation already in
            # flight with the old full buffer still runs at one transitional
            # odd total; everything after is aligned again.)
            total = 1 << int(np.ceil(np.log2(max(old_total,
                                                 2 * self.store_cap))))
            self.buffer_cap = total - self.store_cap
        m = self.store_cap
        if fk.shape[0] >= m:
            # uniques are compacted (sorted) at the front: a slice IS the store
            self.store_keys, self.store_cnts = fk[:m], fc[:m]
        else:
            pad = m - fk.shape[0]
            self.store_keys = jnp.concatenate(
                [fk, jnp.full((pad,), SENTINEL, jnp.int64)])
            self.store_cnts = jnp.concatenate(
                [fc, jnp.zeros((pad,), jnp.int32)])

    def _consolidate(self) -> None:
        if self._offset_host == 0:
            return
        self._resolve()
        fn = (_consolidate_merge_split if self.mode == "merge"
              else _consolidate_full_split)
        self._pending = fn(
            self.store_keys, self.store_cnts, self.buf, self.offset)
        # keep buffer >= store so merge-mode padding stays bounded after growth
        self.buffer_cap = max(self.buffer_cap, self.store_cap)
        self.buf = jnp.full((self.buffer_cap,), SENTINEL, jnp.int64)
        self.offset = jnp.int32(0)
        self._offset_host = 0

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """Returns key-sorted (keys, counts) on host, counts clamped at 32767."""
        self._consolidate()
        self._resolve()
        sk = np.asarray(self.store_keys[: self._live])
        sc = np.asarray(self.store_cnts[: self._live])
        order = np.argsort(sk, kind="stable")
        return sk[order], np.minimum(sc[order], 32767).astype(np.int32)


# ---------------------------------------------------------------------------
# Chunked (multi-batch fused) append: one dispatch per chunk of read batches
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k", "hasher"),
                   donate_argnums=(0,))
def _append_multi_kernel(buf, offset, codes_chunk, k: int, hasher: str | None):
    """Extract + append a whole (NB, B, L) chunk of batches in ONE dispatch.

    Identical semantics to NB sequential _append_kernel calls (pad
    rows/batches carry -1 codes -> SENTINEL keys, dropped at consolidation),
    fused via lax.scan so the per-call dispatch overhead is paid once per
    chunk instead of once per batch. Returns (buf, new_offset)."""
    def step(carry, codes_b):
        buf, off = carry
        flat = window_keys(codes_b, k, hasher)  # as in _append_kernel
        buf = jax.lax.dynamic_update_slice(buf, flat, (off,))
        return (buf, off + flat.shape[0]), jnp.int32(0)

    (buf, offset), _ = jax.lax.scan(step, (buf, offset), codes_chunk)
    return buf, offset


class ChunkedStreamCounter:
    """StreamCounter with multi-batch fused dispatch (MC_COUNT_ENGINE=chunk).

    Host accumulates packed batches; every `chunk_batches` batches (or at
    finalize) one _append_multi_kernel call extracts + appends the whole
    chunk. Consolidation, growth and finalize delegate verbatim to the
    wrapped StreamCounter, so equality with the sort engine is structural
    (pinned in tests/test_counting.py). Default chunk size fills the append
    buffer exactly once per chunk. The fused unit here is ONLY the cheap
    extract+append scan -- consolidation stays in the StreamCounter's
    units.
    """

    def __init__(self, batch: int, max_len: int,
                 chunk_batches: int | None = None, **stream_kw):
        self.sc = StreamCounter(**stream_kw)
        self.batch = batch
        self.max_len = max_len
        self._explicit_chunk = chunk_batches
        self.chunk_batches = chunk_batches or 1  # re-fit once k is known
        self._pending: list[np.ndarray] = []
        self._k: int | None = None
        self._hasher: str | None = None

    def _per_batch(self) -> int:
        # appended lanes per batch AFTER the k-1 column trim (see
        # _append_kernel); requires k, hence computed lazily
        return self.batch * max(self.max_len - self._k + 1, 0)

    def add_codes(self, codes, k: int, hasher: str | None) -> None:
        if self._k is None:
            self._k = k
            if self._explicit_chunk is None:
                self.chunk_batches = max(
                    self.sc.buffer_cap // max(self._per_batch(), 1), 1)
        self._k, self._hasher = k, hasher
        self._pending.append(np.asarray(codes, np.int32))
        if len(self._pending) >= self.chunk_batches:
            self._flush()

    def _flush(self) -> None:
        if not self._pending:
            return  # nothing ever added: _k may still be None
        sc = self.sc
        per_batch = self._per_batch()
        if per_batch <= 0:
            self._pending.clear()
            return
        while self._pending:
            incoming = self.chunk_batches * per_batch
            if sc._offset_host + incoming > sc.buffer_cap:
                sc._consolidate()
            # ORDER MATTERS: _consolidate can SHRINK the buffer (store
            # growth realigns buffer+store to a power-of-two total), so the
            # chunk size is re-fit AFTER consolidating -- sizing first and
            # consolidating second would let the fused append overflow the
            # new buffer, where dynamic_update_slice clamps and silently
            # drops keys. One growth event costs one recompile at the
            # smaller NB.
            if incoming > sc.buffer_cap:
                if per_batch > sc.buffer_cap:
                    raise ValueError(
                        f"one batch ({per_batch} keys) exceeds the append "
                        f"buffer ({sc.buffer_cap} lanes)")
                self.chunk_batches = max(sc.buffer_cap // per_batch, 1)
                incoming = self.chunk_batches * per_batch
            nb = self.chunk_batches
            group, self._pending = self._pending[:nb], self._pending[nb:]
            chunk = np.full((nb, self.batch, self.max_len), -1, np.int32)
            for i, b in enumerate(group):
                chunk[i, : b.shape[0], : b.shape[1]] = b
            sc.buf, sc.offset = _append_multi_kernel(
                sc.buf, sc.offset, jnp.asarray(chunk), self._k, self._hasher)
            sc._offset_host += incoming

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        self._flush()
        return self.sc.finalize()
