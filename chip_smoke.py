#!/usr/bin/env python3
"""Smoke run of the main path on an NVIDIA GPU, with exact checks.

    python chip_smoke.py              # one card: phases 1-4
    python chip_smoke.py --cards 4    # four cards: phase 5 only

Every phase drives the CLI in this process (metacherchant_tpu.runner.main),
on reads generated from --seed, and holds its result to an independent
reference with exact equality (all of this is integer work):

1. environment-finder at a realistic size: a synthetic gut-like community
   (20 genomes of 1-2 Mbp, log-normal abundance, 1 M pairs of 150 bp reads,
   0.5 % substitutions) and a panel of 16 target genes, with the README's
   settings. The device-counted map must equal a NumPy reference (sliding
   canonical keys + np.unique), and every gene gets its outputs.
2. The same flow at small size: outputs byte-identical to MC_HOST_COUNT=1.
3. The hashed regime (k=55, poly and fnv1a): the map equals hash_codes_np +
   np.unique over the same reads.
4. Every other device path a user can reach (counting engines, device BFS
   engines, hashed device BFS, device contraction, device classification),
   each equal to its host result.
5. (--cards 4) the sharded counter and the sharded BFS over a 1-D mesh of
   four cards, equal to the one-card sort map and to the native BFS.

The script exits non-zero, and prints no result line, when JAX finds no GPU,
when a native library fails to build or load, or when any phase fails. Its
last line is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

K = 31
READ_LEN = 150
SATURATION = 32767
#: --maxradius of the small runs (phases 2-5); phase 1 uses the README's 1000
SMALL_RADIUS = 300
#: radius of the hashed runs and of the sharded BFS, whose layers are costly
HASHED_RADIUS = 100


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


@contextlib.contextmanager
def phase(name: str):
    """Times a phase and reports the device's peak memory after it. An
    exception propagates: a failed phase ends the run."""
    import jax
    log(f"== phase {name}")
    t0 = time.perf_counter()
    yield
    stats = jax.devices()[0].memory_stats() or {}
    log(f"== phase {name}: ok in {time.perf_counter() - t0:.2f} s, peak "
        f"device memory {stats.get('peak_bytes_in_use', 'n/a')} bytes")


# ---------------------------------------------------------------------------
# synthetic data (codes 0..3 = A, G, C, T; complement of c is 3 - c)
# ---------------------------------------------------------------------------

def make_community(rng, n_genomes: int, len_lo: int, len_hi: int,
                   n_pairs: int, err: float = 0.005, sigma: float = 1.0,
                   insert: int = 300):
    """Genomes with log-normal abundance and paired reads sampled from them.

    Returns (genomes, cover, r1, r2): cover[g] is genome g's expected k-mer
    coverage; r1/r2 are (n_pairs, READ_LEN) uint8 code rows, mates on
    opposite strands, with `err` substitutions per base."""
    lens = rng.integers(len_lo, len_hi + 1, n_genomes)
    genomes = [rng.integers(0, 4, n, dtype=np.uint8) for n in lens]
    weight = rng.lognormal(0.0, sigma, n_genomes) * lens
    gid = rng.choice(n_genomes, n_pairs, p=weight / weight.sum())
    r1 = np.empty((n_pairs, READ_LEN), np.uint8)
    r2 = np.empty((n_pairs, READ_LEN), np.uint8)
    ar = np.arange(READ_LEN)
    for g in range(n_genomes):
        idx = np.flatnonzero(gid == g)
        size = np.clip(rng.normal(insert, insert / 10, idx.size).astype(
            np.int64), READ_LEN, 2 * insert)
        start = (rng.random(idx.size) * (lens[g] - size + 1)).astype(np.int64)
        r1[idx] = genomes[g][start[:, None] + ar]
        r2[idx] = 3 - genomes[g][(start + size - 1)[:, None] - ar]
    flip = rng.random(n_pairs) < 0.5
    r1[flip], r2[flip] = r2[flip].copy(), r1[flip].copy()
    for r in (r1, r2):
        hit = rng.random(r.shape) < err
        r[hit] = (r[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    reads_of = np.bincount(gid, minlength=n_genomes) * 2
    cover = reads_of * (READ_LEN - K + 1) / lens
    return genomes, cover, r1, r2


def pick_genes(rng, genomes, cover, n_abundant: int, n_rare: int,
               per_genome: int = 2, length: int = 1000, min_cover=5.0):
    """Gene sequences from the most abundant genomes and from the rarest
    ones whose k-mer coverage still clears the --coverage threshold."""
    order = np.argsort(cover)[::-1]
    rare = [g for g in order[::-1] if cover[g] >= min_cover][:n_rare]
    chosen = list(order[:n_abundant]) + [g for g in rare
                                         if g not in order[:n_abundant]]
    genes = []
    for g in chosen:
        for _ in range(per_genome):
            s = int(rng.integers(0, genomes[g].size - length))
            genes.append(genomes[g][s:s + length])
    return genes


def write_fastq(path: str, reads: np.ndarray) -> None:
    n, L = reads.shape
    alphabet = np.frombuffer(b"AGCT", np.uint8)
    head = 11  # "@r" + 8 digits + "\n"
    rec = np.empty((n, head + L + 3 + L + 1), np.uint8)
    rec[:, 0], rec[:, 1] = ord("@"), ord("r")
    digits = (np.arange(n)[:, None] // 10 ** np.arange(7, -1, -1)) % 10
    rec[:, 2:10] = digits + ord("0")
    rec[:, 10] = ord("\n")
    rec[:, head:head + L] = alphabet[reads]
    rec[:, head + L:head + L + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, head + L + 3:-1] = ord("I")
    rec[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(rec.tobytes())


def write_genes(path: str, genes) -> list[str]:
    alphabet = np.frombuffer(b"AGCT", np.uint8)
    names = [f"gene{i:02d}" for i in range(len(genes))]
    with open(path, "w") as f:
        for name, g in zip(names, genes):
            f.write(f">{name}\n{alphabet[g].tobytes().decode()}\n")
    return names


def write_sample(d: str, r1, r2, genes) -> tuple[list[str], str, list[str]]:
    os.makedirs(d, exist_ok=True)
    reads = [os.path.join(d, "r1.fastq"), os.path.join(d, "r2.fastq")]
    write_fastq(reads[0], r1)
    write_fastq(reads[1], r2)
    genes_path = os.path.join(d, "genes.fasta")
    return reads, genes_path, write_genes(genes_path, genes)


# ---------------------------------------------------------------------------
# independent references
# ---------------------------------------------------------------------------

def exact_keys_np(reads: np.ndarray, k: int) -> np.ndarray:
    """Canonical 2-bit keys of every k-window of (N, L) all-base code rows.

    Window values are built by doubling: parts[m][:, j] packs codes
    j..j+m-1, and a k-window joins the parts of k's binary digits."""
    c = reads.astype(np.uint64)
    fw_parts, rc_parts = {1: c}, {1: np.uint64(3) - c}
    m = 1
    while 2 * m <= k:
        a, b = fw_parts[m], rc_parts[m]
        fw_parts[2 * m] = (a[:, :-m] << np.uint64(2 * m)) | a[:, m:]
        rc_parts[2 * m] = b[:, :-m] | (b[:, m:] << np.uint64(2 * m))
        m *= 2
    W = c.shape[1] - k + 1
    fw = np.zeros((c.shape[0], W), np.uint64)
    rc = np.zeros_like(fw)
    off = 0
    for bit in reversed(range(k.bit_length())):
        m = 1 << bit
        if k & m:
            fw = (fw << np.uint64(2 * m)) | fw_parts[m][:, off:off + W]
            rc |= rc_parts[m][:, off:off + W] << np.uint64(2 * off)
            off += m
    return np.minimum(fw.view(np.int64), rc.view(np.int64)).ravel()


def hashed_keys_np(reads: np.ndarray, k: int, hasher: str) -> np.ndarray:
    from metacherchant_tpu.ops.kmers import hash_codes_np
    wins = np.lib.stride_tricks.sliding_window_view(reads, k, axis=1)
    step = max((1 << 20) // wins.shape[1], 1)
    return np.concatenate([
        hash_codes_np(wins[i:i + step].reshape(-1, k), hasher)
        for i in range(0, wins.shape[0], step)])


def reference_map(read_sets, keys_fn, chunk: int = 1 << 17):
    keys = np.concatenate([keys_fn(r[i:i + chunk]) for r in read_sets
                           for i in range(0, r.shape[0], chunk)])
    uniq, counts = np.unique(keys, return_counts=True)
    return uniq, np.minimum(counts, SATURATION).astype(np.int32)


def assert_map_equal(kmap, ref, what: str) -> None:
    keys, counts = ref
    same = (np.array_equal(kmap.keys, keys)
            and np.array_equal(kmap.counts, counts))
    log(f"{what}: {len(kmap)} distinct k-mers, reference {keys.size}: "
        f"{'equal' if same else 'DIFFERENT'}")
    assert same, what


# ---------------------------------------------------------------------------
# CLI driving
# ---------------------------------------------------------------------------

class Capture:
    """Records the KmerMap each CLI run counts (device or host counter)."""

    def __init__(self):
        import metacherchant_tpu.tools.environment_finder as ef
        self.kmap = None
        self.count_s = None
        for name in ("count_kmers_device", "count_kmers_host"):
            setattr(ef, name, self._wrap(getattr(ef, name)))

    def _wrap(self, fn):
        def counted(*args, **kwargs):
            t0 = time.perf_counter()
            self.kmap = fn(*args, **kwargs)
            self.count_s = time.perf_counter() - t0
            return self.kmap
        return counted


@contextlib.contextmanager
def env(**values):
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_cli(args: list[str]) -> float:
    from metacherchant_tpu.runner import main as runner_main
    t0 = time.perf_counter()
    rc = runner_main(args)
    assert rc == 0, f"CLI exited {rc}: {' '.join(args)}"
    return time.perf_counter() - t0


def env_finder(work: str, tag: str, reads, genes_path: str, k: int,
               coverage: int, radius: int, extra=()) -> str:
    out = os.path.join(work, f"out_{tag}")
    secs = run_cli(["-t", "environment-finder", "-k", str(k), "-i", *reads,
                    "--seq", genes_path, "-o", out, "--coverage",
                    str(coverage), "--maxradius", str(radius),
                    "-w", os.path.join(work, f"wd_{tag}"), *extra])
    log(f"environment-finder [{tag}]: {secs:.2f} s")
    return out


def tree(d: str) -> dict[str, bytes]:
    files = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                files[os.path.relpath(p, d)] = f.read()
    return files


def assert_outputs(out: str, names: list[str]) -> None:
    for name in names:
        for f in ("graph.txt", "graph.gfa", "seqs.fasta"):
            p = os.path.join(out, name, f)
            assert os.path.isfile(p) and os.path.getsize(p) > 0, p
    log(f"outputs: {len(names)} gene directories, each with non-empty "
        "graph.txt, graph.gfa and seqs.fasta")


def assert_same_tree(a: str, b: str, what: str) -> None:
    ta, tb = tree(a), tree(b)
    same = ta == tb
    log(f"{what}: {len(ta)} files, {'byte-identical' if same else 'DIFFERENT'}")
    assert same and ta, what


def graphs(out: str, names: list[str]) -> dict:
    from metacherchant_tpu.io.writers import load_graph_txt
    return {n: load_graph_txt(os.path.join(out, n, "graph.txt"))
            for n in names}


def picture(out: str, names: list[str]) -> dict:
    """Unitig set up to strand plus GFA S/L record counts per gene: what the
    device contraction guarantees (it may order records and pick strands
    differently from the host sweep)."""
    from metacherchant_tpu.dna import reverse_complement
    res = {}
    for n in names:
        d = os.path.join(out, n)
        with open(os.path.join(d, "seqs.fasta")) as f:
            seqs = sorted(min(s, reverse_complement(s))
                          for s in f.read().splitlines()
                          if not s.startswith(">"))
        with open(os.path.join(d, "graph.gfa")) as f:
            lines = f.read().splitlines()
        res[n] = (seqs, sum(l.startswith("S\t") for l in lines),
                  sum(l.startswith("L\t") for l in lines))
    return res


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase1(rng, work: str, cap: Capture, pairs: int) -> None:
    genomes, cover, r1, r2 = make_community(rng, 20, 1_000_000, 2_000_000,
                                            pairs)
    genes = pick_genes(rng, genomes, cover, 4, 4)
    reads, genes_path, names = write_sample(os.path.join(work, "p1"), r1, r2,
                                            genes)
    log(f"community: 20 genomes, {sum(g.size for g in genomes)} bp, "
        f"{pairs} pairs of {READ_LEN} bp, {len(names)} genes; k-mer "
        f"coverage per genome {np.round(np.sort(cover), 1).tolist()}")
    out = env_finder(work, "p1", reads, genes_path, K, 5, 1000,
                     ("-p", "4"))
    log(f"device count (inside the CLI run): {cap.count_s:.2f} s")
    assert_outputs(out, names)
    t0 = time.perf_counter()
    ref = reference_map((r1, r2), lambda r: exact_keys_np(r, K))
    log(f"numpy reference: {time.perf_counter() - t0:.2f} s")
    assert_map_equal(cap.kmap, ref, "phase 1 map vs numpy reference")


def small_sample(rng, work: str, pairs: int = 10_000):
    genomes, cover, r1, r2 = make_community(rng, 1, 50_000, 60_000, pairs)
    genes = pick_genes(rng, genomes, cover, 1, 0, per_genome=3)
    reads, genes_path, names = write_sample(os.path.join(work, "small"),
                                            r1, r2, genes)
    return reads, genes_path, names, (r1, r2)


def run_phases_one_card(rng, work: str, cap: Capture, pairs: int) -> None:
    with phase("1: environment-finder, realistic size, vs numpy reference"):
        phase1(rng, work, cap, pairs)
    cap.kmap = None

    with phase("2: small flow, device vs host counting"):
        reads, genes_path, names, _ = small_sample(rng, work)
        dev = env_finder(work, "p2_dev", reads, genes_path, K, 5, SMALL_RADIUS)
        with env(MC_HOST_COUNT="1"):
            host = env_finder(work, "p2_host", reads, genes_path, K, 5,
                            SMALL_RADIUS)
        host_map = cap.kmap
        assert_outputs(host, names)
        assert_same_tree(dev, host, "phase 2 outputs, device vs host count")

    hashed = {}
    with phase("3: hashed regime k=55, poly and fnv1a"):
        genomes, cover, r1, r2 = make_community(rng, 2, 100_000, 120_000,
                                                50_000)
        genes = pick_genes(rng, genomes, cover, 2, 0, per_genome=1)
        h_reads, h_genes, h_names = write_sample(
            os.path.join(work, "hashed"), r1, r2, genes)
        for hasher in ("poly", "fnv1a"):
            out = env_finder(work, f"p3_{hasher}", h_reads, h_genes, 55, 3,
                             HASHED_RADIUS, ("--forcehash", "--hash", hasher))
            assert_outputs(out, h_names)
            ref = reference_map((r1, r2),
                                lambda r: hashed_keys_np(r, 55, hasher))
            assert_map_equal(cap.kmap, ref, f"phase 3 {hasher} map vs "
                             "hash_codes_np reference")
            hashed[hasher] = out

    with phase("4: every other device path vs its host result"):
        for engine in ("chunk", "merge", "hash"):
            with env(MC_COUNT_ENGINE=engine):
                out = env_finder(work, f"p4_{engine}", reads, genes_path, K,
                                 5, SMALL_RADIUS)
            assert_map_equal(cap.kmap, (host_map.keys, host_map.counts),
                             f"MC_COUNT_ENGINE={engine} map vs host count")
            assert_same_tree(out, host, f"MC_COUNT_ENGINE={engine} outputs")
        phase4_stream_merge(reads, host_map)
        for engine in ("dense", "probe"):
            with env(MC_DEVICE_BFS="1", MC_DEVICE_BFS_ENGINE=engine):
                out = env_finder(work, f"p4_bfs_{engine}", reads, genes_path,
                                 K, 5, SMALL_RADIUS)
            same = graphs(out, names) == graphs(host, names)
            log(f"MC_DEVICE_BFS_ENGINE={engine} graph.txt vs native BFS: "
                f"{'equal' if same else 'DIFFERENT'}")
            assert same, engine
        with env(MC_DEVICE_BFS="1"):
            out = env_finder(work, "p4_bfs_hashed", h_reads, h_genes, 55, 3,
                             HASHED_RADIUS, ("--forcehash", "--hash", "poly"))
        same = graphs(out, h_names) == graphs(hashed["poly"], h_names)
        log(f"hashed device BFS graph.txt vs native BFS: "
            f"{'equal' if same else 'DIFFERENT'}")
        assert same, "hashed device BFS"
        with env(MC_DEVICE_CONTRACT="1"):
            out = env_finder(work, "p4_contract", reads, genes_path, K, 5,
                             SMALL_RADIUS)
        same = picture(out, names) == picture(host, names)
        log(f"MC_DEVICE_CONTRACT=1 unitigs and GFA records vs host sweep: "
            f"{'equal' if same else 'DIFFERENT'}")
        assert same, "device contraction"
        classify = {}
        for tag, flag in (("host", None), ("device", "1")):
            out = os.path.join(work, f"p4_classify_{tag}")
            with env(MC_DEVICE_CLASSIFY=flag):
                run_cli(["-t", "reads-classifier", "-k", str(K),
                         "-i", reads[0], "-r", reads[1], h_reads[0],
                         "-o", out, "-w", os.path.join(work, f"wd_c_{tag}")])
            classify[tag] = out
        assert_same_tree(classify["device"], classify["host"],
                         "MC_DEVICE_CLASSIFY=1 reads-classifier outputs")


def phase4_stream_merge(reads, host_map) -> None:
    """StreamCounter(mode='merge') with a small store, so consolidation
    runs many times and the store grows."""
    import jax.numpy as jnp
    from metacherchant_tpu import native
    from metacherchant_tpu.kmer_map import KmerMap
    from metacherchant_tpu.ops.kmers import pack_reads
    from metacherchant_tpu.ops.sortcount import StreamCounter

    sc = StreamCounter(buffer_cap=1 << 20, store_cap=1 << 14, mode="merge")
    for path in reads:
        codes, offs = native.parse_fragments(path, "fastq")
        frags = [codes[a:b] for a, b in zip(offs[:-1], offs[1:])]
        for i in range(0, len(frags), 2048):
            sc.add_codes(jnp.asarray(pack_reads(frags[i:i + 2048], 2048,
                                                READ_LEN)), K, None)
    keys, counts = sc.finalize()
    assert_map_equal(KmerMap(keys, counts), (host_map.keys, host_map.counts),
                     "StreamCounter(mode='merge') map vs host count")


def run_phase_four_cards(rng, work: str, cap: Capture) -> None:
    import jax
    import metacherchant_tpu.parallel.sharded_count as shc
    from metacherchant_tpu import native
    from metacherchant_tpu.counting import seed_keys_of_sequence
    from metacherchant_tpu.parallel.sharded_bfs import run_sharded_bfs
    from metacherchant_tpu.parallel.sharded_count import make_mesh

    devices = jax.devices()
    assert len(devices) == 4, f"--cards 4 needs four devices, JAX has {devices}"
    placed = set()
    items_host = shc.ShardedCounter.items_host

    def recorded(self):
        placed.update(s.device for s in self.tkeys.addressable_shards)
        return items_host(self)

    shc.ShardedCounter.items_host = recorded
    with phase("5: sharded count and sharded BFS on four cards"):
        genomes, cover, r1, r2 = make_community(rng, 3, 200_000, 300_000,
                                                100_000)
        genes = pick_genes(rng, genomes, cover, 3, 0, per_genome=1)
        reads, genes_path, names = write_sample(os.path.join(work, "p5"),
                                                r1, r2, genes)
        one = env_finder(work, "p5_sort", reads, genes_path, K, 5,
                         SMALL_RADIUS)
        one_map = cap.kmap
        with env(MC_COUNT_ENGINE="sharded"):
            four = env_finder(work, "p5_sharded", reads, genes_path, K, 5,
                              SMALL_RADIUS)
        log(f"sharded table shards on devices: "
            f"{sorted(str(d) for d in placed)}")
        assert placed == set(devices), placed
        assert_map_equal(cap.kmap, (one_map.keys, one_map.counts),
                         "sharded map (4 cards) vs one-card sort map")
        assert_same_tree(four, one, "sharded vs one-card outputs")

        mesh = make_mesh(devices)
        alphabet = "AGCT"
        for name, g in zip(names, genes):
            seq = "".join(alphabet[c] for c in g)
            seeds = np.unique(seed_keys_of_sequence(seq, K, None))
            t0 = time.perf_counter()
            got = run_sharded_bfs(seeds, one_map, K, 5, 0, HASHED_RADIUS,
                                  mesh, frontier_cap=1 << 14)
            secs = time.perf_counter() - t0
            want, _ = native.bfs_exact(one_map.keys, one_map.counts, seeds,
                                       K, 5, 0, HASHED_RADIUS, None, False)
            same = np.array_equal(got, np.sort(want))
            log(f"sharded BFS {name} ({got.size} k-mers, {secs:.2f} s) vs "
                f"native BFS: {'equal' if same else 'DIFFERENT'}")
            assert same, name


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--pairs", type=int, default=1_000_000,
                    help="read pairs of phase 1 (default 1 M)")
    args = ap.parse_args()

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        fail(f"no GPU: JAX found {devices[0].platform} devices only")
    import metacherchant_tpu
    if not os.path.abspath(metacherchant_tpu.__file__).startswith(HERE):
        fail("metacherchant_tpu is not the copy next to this script")
    from metacherchant_tpu import native

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    for line in card.stdout.strip().splitlines():
        log(f"card: {line.strip()}")
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    io_ok, bfs_ok = native.available(), native.bfs_available()
    log(f"native parser loaded: {io_ok}; native BFS loaded: {bfs_ok}")
    if not (io_ok and bfs_ok):
        fail("a native library failed to build or load")

    work = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(args.seed)
    cap = Capture()
    t0 = time.perf_counter()
    if args.cards == 4:
        run_phase_four_cards(rng, work, cap)
    else:
        log(f"scale cut: phase 1 runs {args.pairs} read pairs; a real gut "
            "sample has 10-50 M")
        run_phases_one_card(rng, work, cap, args.pairs)
    shutil.rmtree(work, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t0:.2f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
