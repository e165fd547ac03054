"""K-mer counting drivers: stream reads -> device extraction -> device table.

Device redesign of the reference counting stack
(src/io/IOUtils.java:200-248 loadReads; src/io/ReadsDispatcher.java:34-53;
src/io/LargeKIOUtils.java:40-88 hashed regime): instead of a thread pool
mutating a striped shared map, reads are packed host-side into fixed-shape
(B, L) code batches, canonical keys are extracted with one fused scan on
device, and unique (key, count) pairs are aggregated into a device-resident
store (a sorted key/count store by default, ops/sortcount.py). Long fragments are chunked with k-1 overlap so every
window is represented exactly once.
"""
from __future__ import annotations

import logging
from typing import Iterable, Iterator

import numpy as np
import jax.numpy as jnp

from .kmer_map import KmerMap
from .ops.kmers import canonical_kmers, pack_reads, hash_str
from .ops.hashtable import DeviceHashTable
from .io.readers import iter_reads_split
from .dna import canonical_code, kmer_to_code, split_on_n

logger = logging.getLogger("metacherchant")

DEFAULT_BATCH = 4096
DEFAULT_LEN = 256


def _chunk_fragment(frag: np.ndarray, k: int, max_len: int) -> Iterator[np.ndarray]:
    """Split a long fragment into <=max_len windows with k-1 overlap."""
    if len(frag) <= max_len:
        yield frag
        return
    stride = max_len - (k - 1)
    for start in range(0, len(frag) - (k - 1), stride):
        yield frag[start:start + max_len]


def iter_fragments(files: Iterable[str], k: int, min_len: int,
                   max_len: int) -> Iterator[np.ndarray]:
    """All countable fragments from the input files.

    min_len mirrors loadReads' minSeqLen filter applied to the whole read
    (src/io/IOUtils.java:199-214: splitting happens in the reader, the length
    filter applies per emitted fragment)."""
    for f in files:
        for frag in iter_reads_split(str(f)):
            if len(frag) < max(min_len, k):
                continue
            yield from _chunk_fragment(frag, k, max_len)


def _native_batches(path: str, k: int, min_len: int, batch: int,
                    max_len: int) -> Iterator[np.ndarray] | None:
    """Whole-file packed (batch, max_len) code batches via the native parser
    + vectorized chunking/packing; None -> caller uses the Python per-fragment
    path. Chunking semantics identical to _chunk_fragment."""
    from . import native
    from .io.readers import detect_file_format, determine_quality_format
    try:
        fmt = detect_file_format(path)
    except IOError:
        return None
    if not (native.supports(fmt) and native.available()):
        return None
    qoffset = 33
    if fmt.split(".")[0] == "fastq":
        qoffset = 33 if determine_quality_format(path) == "sanger" else 64
    try:
        codes, offs = native.parse_fragments(path, fmt, qoffset)
    except native.NativeIOError as e:
        if "Invalid nucleotide" in str(e):
            from .io.readers import SequenceError
            raise SequenceError(str(e)) from None
        return None

    def gen():
        lens = np.diff(offs)
        starts = offs[:-1]
        keep = lens >= max(min_len, k)
        lens_k, starts_k = lens[keep], starts[keep]
        if lens_k.size == 0:
            return
        stride = max_len - (k - 1)
        nch = np.where(lens_k <= max_len, 1,
                       -(-(lens_k - (k - 1)) // stride)).astype(np.int64)
        frag_id = np.repeat(np.arange(starts_k.size), nch)
        first = np.repeat(np.cumsum(nch) - nch, nch)
        rank = np.arange(frag_id.size) - first
        cstart = starts_k[frag_id] + rank * stride
        clen = np.minimum(max_len, lens_k[frag_id] - rank * stride)
        ar = np.arange(max_len)
        for b0 in range(0, cstart.size, batch):
            cs, cl = cstart[b0:b0 + batch], clen[b0:b0 + batch]
            out = np.full((batch, max_len), -1, np.int32)
            mask = ar[None, :] < cl[:, None]
            src = cs[:, None] + ar[None, :]
            out[: cs.size][mask] = codes[src[mask]]
            yield out

    return gen()


def _sort_geometry(table_log2: int, batch: int, max_len: int
                   ) -> tuple[int, int]:
    """(buffer_cap, store_cap) for the sort/chunk engines: env-pinned lane
    counts when MC_SORT_BUF_LANES / MC_SORT_STORE_LANES are set, else sized
    from table_log2 with buffer + store at an exact power of two."""
    import os
    buf_env = os.environ.get("MC_SORT_BUF_LANES")
    store_env = os.environ.get("MC_SORT_STORE_LANES")
    store_cap = int(store_env) if store_env else (1 << table_log2)
    if buf_env:
        buffer_cap = int(buf_env)
    else:
        min_buf = max((1 << (table_log2 + 2)) - store_cap,
                      2 * batch * max_len)
        total = 1 << int(np.ceil(np.log2(min_buf + store_cap)))
        buffer_cap = total - store_cap
    return buffer_cap, store_cap


def count_kmers_device(files: Iterable[str], k: int, hasher: str | None = None,
                       min_len: int = 0, batch: int = DEFAULT_BATCH,
                       max_len: int = DEFAULT_LEN,
                       table_log2: int = 20,
                       engine: str | None = None) -> KmerMap:
    """Count canonical k-mers of all reads into a KmerMap (device hot path).

    engine: 'sort' (default; loop-free append + bulk-sort consolidation,
    ops/sortcount.py), 'merge' (per-batch small sorts + bitonic-merge
    consolidation, ops/mergecount.py), 'hash' (open-addressing table,
    ops/hashtable.py), or 'sharded' (multi-device).
    Ingestion uses the native (C++) parser + vectorized packing per file when
    available, else the Python per-fragment readers.
    """
    import os
    engine = engine or os.environ.get("MC_COUNT_ENGINE", "sort")
    if batch == DEFAULT_BATCH and os.environ.get("MC_COUNT_BATCH"):
        # companion knob to MC_COUNT_MAX_LEN: pick a batch whose appended
        # lanes (batch*(max_len-k+1)) divide the append buffer ~evenly, so
        # every consolidation is amortized over a full buffer
        batch = max(int(os.environ["MC_COUNT_BATCH"]), 64)
    if max_len == DEFAULT_LEN and os.environ.get("MC_COUNT_MAX_LEN"):
        # packing-density knob: a (B, L) batch appends B*L buffer lanes but
        # only B*(true_len-k+1) real keys; short-read inputs (150 bp
        # Illumina vs the 256 default) waste ~40% of every consolidation on
        # SENTINEL lanes. Long fragments still chunk with k-1 overlap, so
        # any L >= k is correct (test_counting.py pins equality) -- clamp
        # to k so an env value leaked from a smaller-k phase can never
        # produce windowless batches (silently counting nothing).
        max_len = max(int(os.environ["MC_COUNT_MAX_LEN"]), k, 64)
    if engine == "sharded":
        # multi-chip: per-host disjoint file shards, DP batches over the
        # global mesh, hash-sharded table with all_to_all key routing
        # (parallel/sharded_count.py; SURVEY §2.3 P1/P2/P5)
        from .parallel.distributed import (
            initialize_distributed, shard_files_for_host, global_mesh)
        from .parallel.sharded_count import ShardedCounter
        import jax
        initialize_distributed()
        files = shard_files_for_host([str(f) for f in files])
        mesh = global_mesh()
        n = mesh.devices.size
        batch = max(n, (batch // n) * n)
        per_shard = max(table_log2 - int(np.log2(n)) + 1, 12)
        counter = ShardedCounter(mesh, k, hasher,
                                 capacity_log2_per_shard=per_shard,
                                 batch=batch, max_len=max_len)
        sink = lambda codes: counter.add_codes(np.asarray(codes))
    elif engine in ("sort", "chunk"):
        # MC_SORT_BUF_LANES / MC_SORT_STORE_LANES pin raw lane counts; unset
        # -> sized from table_log2 with buffer = 2^t - store, keeping
        # buffer+store at an exact power of two (the consolidation's lane
        # count), so every store size reuses one compiled consolidation
        # shape per total.
        # 'chunk' = the same engine with multi-batch fused dispatch
        # (ops/sortcount.ChunkedStreamCounter): one extract+append call per
        # buffer fill, identical consolidation units and geometry.
        buffer_cap, store_cap = _sort_geometry(table_log2, batch, max_len)
        if engine == "chunk":
            from .ops.sortcount import ChunkedStreamCounter
            counter = ChunkedStreamCounter(batch, max_len,
                                           buffer_cap=buffer_cap,
                                           store_cap=store_cap)
        else:
            from .ops.sortcount import StreamCounter
            counter = StreamCounter(buffer_cap=buffer_cap,
                                    store_cap=store_cap)
        sink = lambda codes: counter.add_codes(codes, k, hasher)
    elif engine == "merge":
        from .ops.mergecount import MergeCounter
        counter = MergeCounter(
            run_cap_log2=int(np.ceil(np.log2(batch * max_len))),
            store_cap_log2=table_log2)
        sink = lambda codes: counter.add_codes(codes, k, hasher)
    else:
        table = DeviceHashTable(capacity_log2=table_log2)
        sink = lambda codes: table.count_insert_codes(codes, k, hasher)

    from .progress import Progress
    files = [str(f) for f in files]
    total_bytes = sum(os.path.getsize(f) for f in files
                      if os.path.exists(f)) or None
    progress = Progress(label="reads", log_every=2_500_000,
                        total_bytes=total_bytes)
    buf: list[np.ndarray] = []

    # the chunk engine packs batches host-side before its fused dispatch, so
    # hand it numpy directly (a jax->numpy round trip per batch would wait
    # for the device); every other engine gets device arrays
    to_dev = (lambda x: x) if engine == "chunk" else jnp.asarray

    def flush():
        if not buf:
            return
        packed = pack_reads(buf, batch, max_len)
        sink(to_dev(packed))
        progress.update(len(buf))
        buf.clear()

    for f in files:
        nb = _native_batches(str(f), k, min_len, batch, max_len)
        if nb is not None:
            flush()  # keep batches file-aligned on the native path
            for packed in nb:
                sink(to_dev(packed))
                progress.update(batch)
        else:
            for frag in iter_fragments([f], k, min_len, max_len):
                buf.append(frag)
                if len(buf) == batch:
                    flush()
        if os.path.exists(f):
            progress.advance_bytes(os.path.getsize(f))
    flush()
    if engine in ("sort", "merge", "chunk", "sharded"):
        keys, counts = (counter.items_host() if engine == "sharded"
                        else counter.finalize())
    else:
        keys, counts = table.items_host()
    logger.debug("k-mers HM size = %d", len(keys))
    return KmerMap(keys, counts)


def count_kmers_host(files: Iterable[str], k: int, hasher: str | None = None,
                     min_len: int = 0) -> KmerMap:
    """Pure-host oracle counter (slow; tests and tiny inputs).

    Mirrors ShortKmer.kmersOf + addAndBound exactly (src/io/IOUtils.java:200-214).
    """
    counts: dict[int, int] = {}
    for f in files:
        for frag in iter_reads_split(str(f)):
            if len(frag) < max(min_len, k):
                continue
            _count_codes_into(counts, frag, k, hasher)
    return KmerMap.from_dict(counts)


def count_sequences_host(seqs: Iterable[str], k: int,
                         hasher: str | None = None) -> KmerMap:
    """Count k-mers of in-memory sequences (host)."""
    from .dna import encode
    counts: dict[int, int] = {}
    for s in seqs:
        for frag in split_on_n(encode(s)):
            if len(frag) >= k:
                _count_codes_into(counts, frag, k, hasher)
    return KmerMap.from_dict(counts)


def _count_codes_into(counts: dict[int, int], codes: np.ndarray, k: int,
                      hasher: str | None) -> None:
    if hasher is None:
        fw = 0
        rc = 0
        mask = (1 << (2 * k)) - 1
        shift = 2 * k - 2
        for i, c in enumerate(codes):
            c = int(c)
            fw = ((fw << 2) | c) & mask
            rc = (rc >> 2) | ((3 - c) << shift)
            if i >= k - 1:
                key = min(fw, rc)
                counts[key] = counts.get(key, 0) + 1
    else:
        from .dna import decode
        s = decode(codes)
        for i in range(len(s) - k + 1):
            key = hash_str(s[i:i + k], hasher)
            counts[key] = counts.get(key, 0) + 1


def load_present_kmer_strings(files: Iterable[str], k: int, hasher: str,
                              kmap: KmerMap, min_len: int = 0,
                              rows_per_batch: int = 1 << 20) -> dict[str, int]:
    """LargeKmerLoader equivalent (src/io/LargeKmerLoader.java:47-76): in the
    hashed regime map keys cannot be decoded back to strings, so re-stream the
    reads and materialize normalized-string -> count for every k-window whose
    canonical hash is present in kmap.

    Hashing is the vectorized batch oracle (exact Java wrap) over ~1M-window
    blocks; presence is one sorted-array probe per block.
    """
    from .dna import CODE_TO_CHAR
    from .ops.kmers import hash_codes_np
    from .algo.environment_hashed import _normalize_rows

    out: dict[str, int] = {}
    buf: list[np.ndarray] = []
    buffered = 0

    def flush():
        nonlocal buffered
        if not buf:
            return
        rows = np.concatenate(buf, axis=0)
        buf.clear()
        buffered = 0
        counts = kmap.get_many(hash_codes_np(rows, hasher))
        present = counts >= 0
        if not present.any():
            return
        rows, counts = rows[present], counts[present]
        norm = _normalize_rows(rows)
        chars = CODE_TO_CHAR[norm.astype(np.int64)]
        # dedup within the block before the python dict loop
        uniq, idx = np.unique(chars, axis=0, return_index=True)
        for row, c in zip(uniq, counts[idx]):
            out[row.tobytes().decode("ascii")] = int(c)

    for frag in iter_fragments(files, k, min_len, max_len=1 << 30):
        if len(frag) < k:
            continue
        wins = np.lib.stride_tricks.sliding_window_view(
            np.asarray(frag, np.uint8), k)
        buf.append(wins)
        buffered += wins.shape[0]
        if buffered >= rows_per_batch:
            flush()
    flush()
    return out


def seed_keys_of_sequence(seq: str, k: int, hasher: str | None) -> np.ndarray:
    """Canonical keys of every k-window of a sequence, in order (host)."""
    n = len(seq) - k + 1
    if n <= 0:
        return np.empty(0, np.int64)
    if hasher is None:
        out = np.empty(n, np.int64)
        code = kmer_to_code(seq[:k])
        out[0] = canonical_code(code, k)
        mask = (1 << (2 * k)) - 1
        from .dna import CHAR_TO_CODE
        for i in range(1, n):
            code = ((code << 2) | int(CHAR_TO_CODE[ord(seq[i + k - 1])])) & mask
            out[i] = canonical_code(code, k)
        return out.astype(np.int64)
    return np.fromiter(
        (hash_str(seq[i:i + k], hasher) for i in range(n)), np.int64, n)
