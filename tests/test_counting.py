"""Counting drivers: device vs host oracle on files, formats, N-splitting."""
import gzip
import os

import numpy as np
import pytest

from metacherchant_tpu.counting import (
    count_kmers_device, count_kmers_host, count_sequences_host)
from metacherchant_tpu.io.readers import (
    detect_file_format, determine_quality_format, iter_reads_split,
    read_rich_fasta)
from metacherchant_tpu.io.writers import write_kmers_bin, read_kmers_bin
from metacherchant_tpu.dna import decode


def _write_fastq(path, reads, quality_char="I"):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{quality_char * len(r)}\n")


def _random_reads(rng, n, length, genome):
    out = []
    for _ in range(n):
        s = rng.integers(0, len(genome) - length)
        out.append(genome[s:s + length])
    return out


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(42)
    return "".join(rng.choice(list("ACGT"), size=3000))


def test_device_vs_host_counting(tmp_path, genome):
    rng = np.random.default_rng(0)
    reads = _random_reads(rng, 200, 80, genome)
    # inject N's to exercise splitting
    reads[3] = reads[3][:20] + "N" + reads[3][21:]
    reads[7] = "N" + reads[7][1:]
    path = str(tmp_path / "reads.fastq")
    _write_fastq(path, reads)
    k = 21
    dev = count_kmers_device([path], k, None, batch=64, max_len=64,
                             table_log2=10)
    host = count_kmers_host([path], k, None)
    assert np.array_equal(dev.keys, host.keys)
    assert np.array_equal(dev.counts, host.counts)


def test_chunk_engine_equals_sort_and_host(tmp_path, genome):
    """MC_COUNT_ENGINE=chunk (multi-batch fused append) is key/count
    identical to the sort engine and the host oracle, across partial final
    chunks and mid-stream consolidations."""
    rng = np.random.default_rng(5)
    reads = _random_reads(rng, 333, 80, genome)  # 333 % batch != 0
    reads[2] = reads[2][:11] + "N" + reads[2][12:]
    path = str(tmp_path / "reads.fastq")
    _write_fastq(path, reads)
    k = 21
    chunk = count_kmers_device([path], k, None, batch=32, max_len=64,
                               table_log2=10, engine="chunk")
    host = count_kmers_host([path], k, None)
    assert np.array_equal(chunk.keys, host.keys)
    assert np.array_equal(chunk.counts, host.counts)


@pytest.mark.parametrize("compaction", ["shift", "sort2"])
def test_consolidation_compaction_modes_equal(genome, monkeypatch,
                                              compaction):
    """MC_SORT_COMPACTION=shift (binary-decomposed shift stages) and the
    sort2 compaction produce identical stores at a power-of-two total;
    non-pow2 totals silently use sort2 (the guard in
    _consolidate_full_split)."""
    import jax.numpy as jnp
    from metacherchant_tpu.ops.sortcount import StreamCounter
    monkeypatch.setenv("MC_SORT_COMPACTION", compaction)
    rng = np.random.default_rng(3)
    k = 15
    sc = StreamCounter(buffer_cap=3072, store_cap=1024)  # total 4096 = 2^12
    assert ((sc.buffer_cap + sc.store_cap) & (sc.buffer_cap + sc.store_cap - 1)) == 0
    batches = [rng.integers(0, 4, size=(8, 64)).astype(np.int32)
               for _ in range(9)]
    for b in batches:
        sc.add_codes(jnp.asarray(b), k, None)
    keys, counts = sc.finalize()
    # host oracle over the same batches
    from metacherchant_tpu.counting import _count_codes_into
    want: dict[int, int] = {}
    for b in batches:
        for row in b:
            _count_codes_into(want, row, k, None)
    wk = np.array(sorted(want), np.int64)
    wc = np.array([min(want[x], 32767) for x in sorted(want)], np.int32)
    assert np.array_equal(keys, wk)
    assert np.array_equal(counts, wc)


def test_count_max_len_env_equals_host(tmp_path, genome, monkeypatch):
    """MC_COUNT_MAX_LEN repacks batches at a tighter width; counts must be
    identical to the host oracle (long fragments still chunk with k-1
    overlap)."""
    rng = np.random.default_rng(11)
    reads = _random_reads(rng, 150, 120, genome)  # 120bp > the 96 cap below
    path = str(tmp_path / "reads.fastq")
    _write_fastq(path, reads)
    k = 21
    monkeypatch.setenv("MC_COUNT_MAX_LEN", "96")
    dev = count_kmers_device([path], k, None, batch=64, table_log2=10)
    host = count_kmers_host([path], k, None)
    assert np.array_equal(dev.keys, host.keys)
    assert np.array_equal(dev.counts, host.counts)


def test_chunked_stream_counter_direct():
    """ChunkedStreamCounter with an explicit small chunk_batches matches
    StreamCounter batch-for-batch, including chunk-boundary consolidation."""
    from metacherchant_tpu.ops.sortcount import (
        StreamCounter, ChunkedStreamCounter)
    rng = np.random.default_rng(9)
    k = 15
    batches = [rng.integers(0, 4, size=(16, 40)).astype(np.int32)
               for _ in range(11)]
    sc = StreamCounter(buffer_cap=4096, store_cap=1024)
    ck = ChunkedStreamCounter(16, 40, chunk_batches=3,
                              buffer_cap=4096, store_cap=1024)
    import jax.numpy as jnp
    for b in batches:
        sc.add_codes(jnp.asarray(b), k, None)
        ck.add_codes(b, k, None)
    k1, c1 = sc.finalize()
    k2, c2 = ck.finalize()
    assert np.array_equal(k1, k2)
    assert np.array_equal(c1, c2)


@pytest.mark.parametrize("hasher", ["poly", "fnv1a"])
def test_device_vs_host_counting_hashed(tmp_path, genome, hasher):
    rng = np.random.default_rng(1)
    reads = _random_reads(rng, 50, 60, genome)
    path = str(tmp_path / "reads.fasta")
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    k = 33
    dev = count_kmers_device([path], k, hasher, batch=32, max_len=80,
                             table_log2=10)
    host = count_kmers_host([path], k, hasher)
    assert np.array_equal(dev.keys, host.keys)
    assert np.array_equal(dev.counts, host.counts)


def test_gzip_and_format_detection(tmp_path, genome):
    rng = np.random.default_rng(2)
    reads = _random_reads(rng, 30, 50, genome)
    path = str(tmp_path / "reads.fastq.gz")
    with gzip.open(path, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    assert detect_file_format(path) == "fastq.gz"
    host = count_kmers_host([path], 15, None)
    ref = count_sequences_host(reads, 15)
    assert np.array_equal(host.keys, ref.keys)
    assert np.array_equal(host.counts, ref.counts)


def test_quality_autodetect(tmp_path):
    sanger = str(tmp_path / "s.fastq")
    _write_fastq(sanger, ["ACGTACGT"], quality_char="#")  # '#'=35 < 64
    assert determine_quality_format(sanger) == "sanger"
    illumina = str(tmp_path / "i.fastq")
    _write_fastq(illumina, ["ACGTACGT"], quality_char="e")
    assert determine_quality_format(illumina) == "illumina"


def test_fastq_split_at_low_quality(tmp_path):
    # phred 0 position splits the read (Trunc reader semantics)
    path = str(tmp_path / "q.fastq")
    with open(path, "w") as f:
        f.write("@r0\nACGTACGTAA\n+\nIIII@IIIII\n")  # '@'=64 -> phred 0 (illumina)
    frags = [decode(c) for c in iter_reads_split(path)]
    assert frags == ["ACGT", "CGTAA"]


def test_long_read_chunking(tmp_path, genome):
    path = str(tmp_path / "long.fasta")
    with open(path, "w") as f:
        f.write(f">g\n{genome}\n")
    k = 25
    dev = count_kmers_device([path], k, None, batch=8, max_len=100,
                             table_log2=10)
    host = count_sequences_host([genome], k)
    assert np.array_equal(dev.keys, host.keys)
    assert np.array_equal(dev.counts, host.counts)


def test_kmers_bin_roundtrip(tmp_path):
    keys = np.array([-10, 5, 99, 2**40], np.int64)
    counts = np.array([1, 3, 7, 2], np.int32)
    p = str(tmp_path / "x.kmers.bin")
    st = str(tmp_path / "x.stat.txt")
    n = write_kmers_bin(p, st, keys, counts, threshold=1)
    assert n == 3  # count > 1
    rk, rc = read_kmers_bin(p)
    assert rk.tolist() == [5, 99, 2**40]
    assert rc.tolist() == [3, 7, 2]
    assert os.path.getsize(p) == 30  # 10-byte records (src/io/KmersLoadWorker.java:9)
    lines = open(st).read().splitlines()
    assert lines[0] == "# k-mer frequency\tnumber of such k-mers"
    assert lines[1] == "1\t1" and lines[2] == "2\t1"


def test_rich_fasta_comments(tmp_path):
    p = str(tmp_path / "g.fasta")
    with open(p, "w") as f:
        f.write(">gene_one extra\nACGT\nACGT\n;second\nTTTT\n")
    recs = read_rich_fasta(p)
    assert [(r.comment, r.seq) for r in recs] == [
        ("gene_one extra", "ACGTACGT"), ("second", "TTTT")]


def test_rle_sorted_weighted_oracle():
    """_rle_sorted vs a numpy oracle: weighted multiset RLE with SENTINEL
    padding, run-total counts, and n_distinct/overflow reporting."""
    import jax.numpy as jnp
    from metacherchant_tpu.ops.sortcount import _rle_sorted
    from metacherchant_tpu.ops.kmers import SENTINEL

    rng = np.random.default_rng(5)
    n = 4096
    keys = rng.integers(0, 300, size=n).astype(np.int64)
    w = rng.integers(1, 40000, size=n).astype(np.int64)  # crosses 32767
    sent = rng.random(n) < 0.25
    keys[sent] = SENTINEL
    w2 = np.where(sent, 0, w)

    m = 1024
    ks, cs, nd = _rle_sorted(jnp.asarray(keys), jnp.asarray(w2.astype(np.int32)), m)
    ks, cs, nd = np.asarray(ks), np.asarray(cs), int(nd)

    want = {}
    for kk, ww in zip(keys, w2):
        if kk != SENTINEL and ww > 0:
            want[int(kk)] = min(want.get(int(kk), 0) + int(ww), 1_000_000_000)
    got = {int(k): int(c) for k, c in zip(ks, cs) if k != SENTINEL}
    assert got == want
    assert nd == len(want)
    # compacted: all live keys first, sorted ascending
    live = ks[ks != SENTINEL]
    assert np.all(np.diff(live) > 0)
    assert np.all(ks[len(live):] == SENTINEL)


def test_stream_counter_raw_caps_equal_oracle():
    """StreamCounter with raw (non-power-of-two) buffer_cap and repeated
    consolidations (buffer much smaller than the stream) matches the host
    oracle -- the bench's full-geometry configuration path."""
    import jax.numpy as jnp
    from metacherchant_tpu.ops.sortcount import StreamCounter
    from metacherchant_tpu.kmer_map import KmerMap

    rng = np.random.default_rng(5)
    k = 21
    reads = ["".join(rng.choice(list("ACGT"), size=60)) for _ in range(96)]
    codes = np.full((96, 60), -1, np.int32)
    lut = {c: i for i, c in enumerate("AGCT")}
    for i, r in enumerate(reads):
        codes[i] = [lut[c] for c in r]

    sc = StreamCounter(buffer_cap=1500, store_cap=512)  # non-pow2 buffer
    for i in range(0, 96, 8):  # 8*60=480 lanes/batch < 1500 -> consolidates
        sc.add_codes(jnp.asarray(codes[i:i + 8]), k, None)
    keys, cnts = sc.finalize()
    got = KmerMap(keys, cnts)
    want = count_sequences_host(reads, k)
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.counts, want.counts)


def test_stream_counter_count_saturation_int32_weights():
    """Counts accumulate across consolidations without int32 overflow and
    clamp at 32767 on finalize (itmo:utils/NumUtils.java:21-26)."""
    import jax.numpy as jnp
    from metacherchant_tpu.ops.sortcount import StreamCounter

    k = 21
    one = "A" * 40  # poly-A: every window is the same canonical kmer
    codes = np.zeros((16, 40), np.int32)
    sc = StreamCounter(buffer_cap=1024, store_cap=256)
    for _ in range(40):  # 40*16*20 = 12800 occurrences of one kmer
        sc.add_codes(jnp.asarray(codes), k, None)
    keys, cnts = sc.finalize()
    assert keys.size == 1
    assert cnts[0] == 12800


@pytest.mark.parametrize("bufcap,storecap", [
    (1024, 1024),   # power-of-two total (no padding)
    (1500, 700),    # non-pow2 total -> buffer-side SENTINEL padding
    (600, 2048),    # store larger than buffer
])
def test_stream_counter_merge_split_equals_oracle(bufcap, storecap):
    """Merge-split consolidation (buffer-only sort + bitonic half-clean +
    cumsum-diff RLE + shift compaction) matches the host oracle across
    repeated consolidations, padding, and store growth."""
    import jax.numpy as jnp
    from metacherchant_tpu.ops.sortcount import StreamCounter
    from metacherchant_tpu.kmer_map import KmerMap

    rng = np.random.default_rng(7)
    k = 15
    genome = "".join(rng.choice(list("ACGT"), size=800))
    reads = [genome[s:s + 50]
             for s in rng.integers(0, 750, size=120)]
    lut = {c: i for i, c in enumerate("AGCT")}
    codes = np.array([[lut[c] for c in r] for r in reads], np.int32)

    sc = StreamCounter(buffer_cap=bufcap, store_cap=storecap, mode="merge")
    for i in range(0, 120, 8):
        sc.add_codes(jnp.asarray(codes[i:i + 8]), k, None)
    keys, cnts = sc.finalize()
    got = KmerMap(keys, cnts)
    want = count_sequences_host(reads, k)
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.counts, want.counts)


def test_stream_counter_auto_routes_merge_above_ceiling():
    """The default consolidation (merge-split; there is no lane ceiling or
    'auto' mode any more) and the sort2 pipeline agree bit-for-bit across
    repeated consolidations."""
    import jax.numpy as jnp
    from metacherchant_tpu.ops import sortcount

    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, size=(64, 40)).astype(np.int32)
    k = 15

    results = []
    for mode in (None, "sort2"):
        kw = {} if mode is None else {"mode": mode}
        sc = sortcount.StreamCounter(buffer_cap=2048, store_cap=1024, **kw)
        assert sc.mode == (mode or "merge")
        for i in range(0, 64, 8):
            sc.add_codes(jnp.asarray(codes[i:i + 8]), k, None)
        results.append(sc.finalize())
    (k1, c1), (k2, c2) = results
    assert k1.size and np.array_equal(k1, k2) and np.array_equal(c1, c2)


def test_stream_counter_mode_validated():
    """Invalid mode strings fail loudly at construction (ADVICE r3: a typo
    silently selected the sort2 path, which can hang compilation)."""
    from metacherchant_tpu.ops.sortcount import StreamCounter
    for bad in ("Merge", "auto"):
        with pytest.raises(ValueError, match="mode"):
            StreamCounter(buffer_cap=1024, store_cap=256, mode=bad)
    for ok in ("sort2", "merge"):
        StreamCounter(buffer_cap=1024, store_cap=256, mode=ok)


def test_stream_counter_growth_realigns_pow2_total():
    """After store growth, buffer+store returns to a power-of-two total
    (shrinking the buffer) so consolidation shapes stay cached; correctness
    vs the host oracle is preserved across the growth event."""
    import jax.numpy as jnp
    from metacherchant_tpu.ops.sortcount import StreamCounter
    from metacherchant_tpu.counting import _count_codes_into

    rng = np.random.default_rng(11)
    k = 13
    sc = StreamCounter(buffer_cap=(1 << 12) - (1 << 8), store_cap=1 << 8,
                       mode="sort2")
    oracle: dict[int, int] = {}
    # enough distinct kmers to overflow the 256-lane store repeatedly
    for step in range(8):
        codes = rng.integers(0, 4, size=(32, 64)).astype(np.int32)
        sc.add_codes(jnp.asarray(codes), k, None)
        for row in codes:
            _count_codes_into(oracle, row.astype(np.int8), k, None)
    keys, counts = sc.finalize()
    assert ((sc.buffer_cap + sc.store_cap)
            & (sc.buffer_cap + sc.store_cap - 1)) == 0, (
        sc.buffer_cap, sc.store_cap)
    assert sc.store_cap >= keys.size
    ok = np.array(sorted(oracle))
    assert np.array_equal(keys, ok)
    assert np.array_equal(counts,
                          np.array([min(oracle[int(x)], 32767) for x in ok]))


def test_chunked_counter_empty_finalize():
    """finalize() before any add_codes must return empty arrays, not crash
    (self-review r5: _per_batch dereferenced k=None)."""
    from metacherchant_tpu.ops.sortcount import ChunkedStreamCounter
    ck = ChunkedStreamCounter(64, 96, buffer_cap=4096, store_cap=1024)
    keys, counts = ck.finalize()
    assert keys.size == 0 and counts.size == 0
