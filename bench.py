"""Benchmark: the BASELINE.md metrics on the accelerator.

Prints ONE JSON line to stdout:
  {"metric": "kmer_count_throughput", "value": N, "unit": "kmers/s/chip",
   "vs_baseline": N/4e7, "extra": {...}}
where extra carries the secondary metrics: time-to-env.txt (wiki fixpoint
AND genome-scale end-to-end), BFS expansions+probes per second (host and
device engines, deep-narrow and dispersed-wide workloads), and classifier
reads/s. Progress goes to stderr.

Primary measurement: the DEFAULT counting engine (ops/sortcount.StreamCounter)
end-to-end via paired differences: MIN over back-to-back (small, big) chain
pairs of T(m_big) - T(m_small); each chain ends with a final consolidation
and one tiny scalar readback, so compile time and readback latency cancel
within a pair.

Orchestration: with no --phase argument this script is a thin stdlib-only
parent that never opens the device: it runs each phase as its own
subprocess, one at a time, under a wall budget; partial stdout of a killed
phase is still parsed. Host-only phases run with JAX_PLATFORMS=cpu.
Counting ladder (first phase to emit kmer_count_throughput wins):
  1. primary, default geometry (buffer + store = 2^24 lanes, batch 8112)
  2. primary, small geometry (2^23 lanes, batch 3968)
  3. primary, tiny geometry (2^19/2^19, batch 2048)
  4. extract+dedup chain / extraction-only chain
then bfs-host / bfs-genome / bfs-device / classify phases, each emitting
its metrics line-by-line the moment they are measured (a killed phase
keeps everything it printed). All phases are DCE-proofed (full-tensor
folds / final consolidation + a scalar readback feed the chain).

The geometry and the method are due to be re-derived for the GPU; until
then no number from this script is a recorded result.

vs_baseline is anchored to EST_JAVA_RATE, an estimate of the reference's
multithreaded JVM counting throughput (striped hash map insert hot loop,
itmo:structures/map/Long2ShortHashMap.java:119-157 addAndBound; ~40M
canonical k-mers/s on a 32-core host). The reference publishes no numbers
(BASELINE.md; a live JVM run is impossible in this image -- no JRE).
"""
import json
import os
import subprocess
import sys
import time

EST_JAVA_RATE = 4.0e7  # est. reference JVM k-mers/s (see module docstring)

K = 31
LEN = 256
GENOME = int(os.environ.get("MC_BENCH_GENOME", "1500000"))
# chain lengths: the difference T(M_BIG) - T(M_SMALL) must dwarf the fixed
# per-chain cost (readback + dispatch tail). 112 batches stage ~940 MB of
# reads on the device.
M_SMALL = int(os.environ.get("MC_BENCH_MSMALL", "16"))
M_BIG = int(os.environ.get("MC_BENCH_MBIG", "112"))

# geometry ladder: (batch, buffer_lanes, store_lanes, genome_cap). Each batch
# appends batch*(LEN-K+1) keys, which must fit the append buffer. The
# consolidation operates on buffer+store lanes; keep that total at an exact
# power of two so every geometry compiles one consolidation shape. The top
# rung puts buffer+store at exactly 2^24: buffer 2^24-2^21 lanes, store 2^21
# (> the 1.5M distinct k-mers of the bench genome, so the store never
# grows/recompiles mid-run). The genome-scale end-to-end phase pins the
# "small" geometry via MC_SORT_*_LANES.
# batch sizes chosen so appends fill the buffer at ~100% utilization: the
# r5 append trim makes incoming = batch*(LEN-K+1) lanes, and consolidation
# cost is FIXED per window (buffer+store sort lanes), so keys amortized per
# consolidation = floor(buf/incoming)*incoming. batch 8112: 8 fills of
# 1,833,312 = 99.9% of the 2^24-2^21 buffer (8192 gave 7 fills = 88%);
# batch 3968: 7 fills = 99.8% of the 2^23-2^21 buffer.
GEOMETRY = {
    "default": (8112, (1 << 24) - (1 << 21), 1 << 21, None),   # sort2 = 2^24
    "small":   (3968, (1 << 23) - (1 << 21), 1 << 21, None),   # sort2 = 2^23
    "tiny":    (2048, 1 << 19, 1 << 19, 400000),               # sort2 = 2^20
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Parent orchestrator (stdlib only -- never opens the device)
# ---------------------------------------------------------------------------

def parent() -> int:
    me = os.path.abspath(__file__)

    plan = [
        (["--phase", "primary"],
         int(os.environ.get("MC_BENCH_BUDGET", "840")), True),
        (["--phase", "primary", "--geom", "small"], 480, True),
        (["--phase", "primary", "--geom", "tiny"], 420, True),
        (["--phase", "dedup"], 300, True),
        (["--phase", "extract"], 240, True),
    ]
    results: dict[str, dict] = {}

    def collect(out: str) -> None:
        for ln in (out or "").splitlines():
            if ln.startswith("{"):
                try:
                    d = json.loads(ln)
                except json.JSONDecodeError:
                    continue
                results.setdefault(d.get("metric", "?"), d)

    for extra, budget, is_primary in plan:
        if is_primary and "kmer_count_throughput" in results:
            break
        log(f"bench phase {' '.join(extra)} (budget {budget}s)")
        proc = subprocess.Popen([sys.executable, me] + extra,
                                stdout=subprocess.PIPE, stderr=sys.stderr,
                                text=True)
        try:
            out, _ = proc.communicate(timeout=budget)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            log("phase exceeded budget; killed")
        collect(out)

    # secondary metrics: BFS expansions/s + time-to-env. Host and device
    # engines run in SEPARATE subprocesses (killing the device half must not
    # lose the host half), each metric printed as its own stdout line the
    # moment it is measured, so partial output of a killed phase still lands
    # in the artifact. Host-only phases never open the device.
    for phase, budget, host_only in (("bfs-host", 300, True),
                                     ("bfs-genome", 560, False),
                                     ("bfs-device", 560, False),
                                     ("classify", 420, True)):
        log(f"bench phase --phase {phase} (budget {budget}s)")
        env = dict(os.environ, JAX_PLATFORMS="cpu") if host_only else None
        proc = subprocess.Popen([sys.executable, me, "--phase", phase],
                                stdout=subprocess.PIPE, stderr=sys.stderr,
                                text=True, env=env)
        try:
            out, _ = proc.communicate(timeout=budget)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            log(f"{phase} phase exceeded budget; killed")
        collect(out)

    head = results.get("kmer_count_throughput")
    if head is None:
        head = {"metric": "kmer_count_throughput", "value": 0.0,
                "unit": "kmers/s/chip", "vs_baseline": 0.0,
                "error": "all phases failed"}
    extra_metrics = {k: {kk: vv for kk, vv in v.items() if kk != "metric"}
                     for k, v in results.items()
                     if k != "kmer_count_throughput"}
    if extra_metrics:
        head["extra"] = extra_metrics
    print(json.dumps(head))
    sys.stdout.flush()
    return 0


# ---------------------------------------------------------------------------
# Measurement phases (one device client per process)
# ---------------------------------------------------------------------------

def _emit(metric: str, rate: float, **extra) -> None:
    d = {
        "metric": metric,
        "value": round(rate, 1),
        "unit": "kmers/s/chip",
        "vs_baseline": round(rate / EST_JAVA_RATE, 3),
    }
    d.update(extra)
    print(json.dumps(d))
    sys.stdout.flush()


def phase_main(which: str, geom: str) -> None:
    import numpy as np
    import metacherchant_tpu  # noqa: F401  (x64, cache config)
    import jax
    import jax.numpy as jnp
    from metacherchant_tpu.ops.kmers import canonical_kmers
    from metacherchant_tpu.ops.hashtable import _batch_unique_impl
    from metacherchant_tpu.ops.sortcount import StreamCounter

    g_batch, g_buf, g_store, g_cap = GEOMETRY[geom]
    batch = int(os.environ.get("MC_BENCH_BATCH", str(g_batch)))
    keys_per_step = batch * (LEN - K + 1)
    buf_lanes = int(os.environ.get("MC_BENCH_BUF_LANES", str(g_buf)))
    store_lanes = int(os.environ.get("MC_BENCH_STORE_LANES", str(g_store)))
    genome = GENOME if g_cap is None else min(GENOME, g_cap)

    probe_fn = jax.jit(
        lambda b: (b.ravel()[123] ^ b.ravel()[456]).astype(jnp.int32))

    def probe(x) -> int:
        return int(probe_fn(x))

    def make_batches(n):
        rng = np.random.default_rng(0)
        g = rng.integers(0, 4, size=genome).astype(np.int8)
        window = np.arange(LEN)
        return [
            jnp.asarray(g[rng.integers(0, g.size - LEN, size=batch)[:, None]
                          + window[None, :]].astype(np.int32))
            for _ in range(n)
        ]

    if which in ("primary", "warm"):
        batches = make_batches(2 if which == "warm" else M_BIG)
        log(f"{len(batches)} batches on device ({keys_per_step} keys/step, "
            f"buf {buf_lanes} lanes, store {store_lanes}, "
            f"sort2 {buf_lanes + store_lanes})")

        def run_chain(m: int) -> float:
            sc = StreamCounter(buffer_cap=buf_lanes, store_cap=store_lanes)
            t0 = time.perf_counter()
            for i in range(m):
                sc.add_codes(batches[i], K, None)
            sc._consolidate()
            v = probe(sc.store_keys)
            dt = time.perf_counter() - t0
            log(f"count chain m={m}: {dt:.2f}s (probe={v}, live={sc._live})")
            return dt

        if which == "warm":
            run_chain(2)   # compiles append + all consolidation units
            # stdout marker (the parent scans stdout, not stderr)
            print("warm pass done", flush=True)
            return
        phase_t0 = time.perf_counter()
        run_chain(2)
        log("compile warm")
        # paired differences: measure (small, big) back-to-back pairs and
        # take the MIN of the per-pair differences; run as many pairs as the
        # phase budget allows and record the per-pair spread
        pair_budget = float(os.environ.get("MC_BENCH_PAIR_BUDGET", "600"))
        max_pairs = max(int(os.environ.get("MC_BENCH_MAX_PAIRS", "8")), 1)
        diffs = []
        t_big = 1e-9
        while len(diffs) < max_pairs:
            if diffs and (time.perf_counter() - phase_t0) > pair_budget:
                break
            t_small = run_chain(M_SMALL)
            t_big = run_chain(M_BIG)
            diffs.append(t_big - t_small)
            log(f"pair {len(diffs)}: diff {diffs[-1]:.2f}s "
                f"({(time.perf_counter() - phase_t0):.0f}s elapsed)")
        diff = min(diffs)
        rates = sorted(round(keys_per_step * (M_BIG - M_SMALL) / d / 1e6, 1)
                       for d in diffs if d > 1e-9)
        t_big = max(t_big, 1e-9)
        if diff < max(0.05 * t_big, 0.2):
            # difference in the noise (steps too cheap vs fixed probe cost):
            # report the conservative absolute rate of the big chain instead
            log(f"difference {diff:.3f}s in noise; using absolute rate")
            _emit("kmer_count_throughput", M_BIG * keys_per_step / t_big)
            return
        per_step = diff / (M_BIG - M_SMALL)
        log(f"count per-step {per_step * 1000:.1f}ms; "
            f"pair rates {rates} M/s")
        _emit("kmer_count_throughput", keys_per_step / per_step,
              pair_rates_mkmers=rates)
        return

    batches = make_batches(M_BIG)
    log(f"{len(batches)} batches on device ({keys_per_step} keys/step)")

    def _fold(x, width=128):
        f = x.ravel().astype(jnp.int64)
        n = (f.shape[0] // width) * width
        return f[:n].reshape(-1, width).sum(axis=0) + f[n:].sum()

    @jax.jit
    def step_dedup(carry, codes):
        keys, _ = canonical_kmers(codes, K, None)
        uk, uc = _batch_unique_impl(keys.ravel())
        return carry + _fold(uk) + _fold(uc)

    @jax.jit
    def step_extract(carry, codes):
        keys, _ = canonical_kmers(codes, K, None)
        return carry + _fold(keys)

    step = step_dedup if which == "dedup" else step_extract

    def chain(m: int) -> float:
        carry = jnp.zeros((128,), jnp.int64)
        t0 = time.perf_counter()
        for i in range(m):
            carry = step(carry, batches[i])
        v = probe(carry)
        dt = time.perf_counter() - t0
        log(f"{which} chain m={m}: {dt:.2f}s (probe={v})")
        return dt

    chain(1)
    t_small = chain(M_SMALL)
    t_big = chain(M_BIG)
    per_step = max(t_big - t_small, 1e-9) / (M_BIG - M_SMALL)
    log(f"{which} per-step {per_step * 1000:.1f}ms")
    _emit(f"kmer_{which}_throughput", keys_per_step / per_step)


# ---------------------------------------------------------------------------
# BFS phase: BASELINE.md secondary metrics
# ---------------------------------------------------------------------------

def phase_bfs_host() -> None:
    """time-to-env.txt + BFS expansions/probes per second, host engine.

    Native C++ FIFO (the CLI default) on the wiki-example workload -- golden
    graph.txt as the k-mer map (the reference's wgs reads are not shipped),
    seed -> BFS -> extend -> graph.txt write, exactly the per-gene
    calculator stage (src/algo/OneSequenceCalculator.java:98-114).

    Metric semantics: an EXPANSION is one dequeued/admitted
    k-mer state; every state probes its 8 string neighbors in the count map
    (OneSequenceCalculator.java:198-213), so probes/s = 8 x expansions/s in
    both host engines and the device kernel alike.
    """
    import numpy as np
    import metacherchant_tpu  # noqa: F401

    from metacherchant_tpu.kmer_map import KmerMap
    from metacherchant_tpu.counting import seed_keys_of_sequence
    from metacherchant_tpu.algo.environment import build_environment
    from metacherchant_tpu.io.writers import (load_graph_txt,
                                              write_graph_txt_codes)
    from metacherchant_tpu.io.readers import read_rich_fasta

    gold = "/root/reference/Hi-C_pipline/example_work_dir/output/1/merged"
    gene_file = "/root/reference/Hi-C_pipline/example/seq.fasta"
    k = 31

    golden_env = load_graph_txt(os.path.join(gold, "graph.txt"))
    keys = np.concatenate(
        [seed_keys_of_sequence(s, k, None) for s in golden_env])
    counts = np.array(list(golden_env.values()), np.int64)
    kmap = KmerMap.from_pairs(keys, counts)
    gene = read_rich_fasta(gene_file)[0].seq
    log(f"bfs host workload: map {len(golden_env)} kmers")

    def run_host():
        t0 = time.perf_counter()
        env = build_environment([gene], k, kmap, min_occ=5,
                                both_directions=False, max_radius=100000,
                                max_kmers=None, trim=False)
        # same writer the CLI uses (vectorized; byte-identical to the dict
        # path, golden-pinned in test_env_golden.py)
        write_graph_txt_codes("/tmp/bench_bfs_graph.txt", env.codes,
                              env.counts, k)
        return time.perf_counter() - t0, int(env.codes.size)

    run_host()  # warm
    runs = [run_host() for _ in range(3)]
    dt = min(t for t, _ in runs)
    n = runs[0][1]
    log(f"host env: {n} kmers best {dt:.3f}s")
    print(json.dumps({"metric": "time_to_env_txt_wiki_example",
                      "value": round(dt, 3), "unit": "s",
                      "engine": "host-native",
                      "caveat": ("fixpoint: map rebuilt from the golden "
                                 "graph.txt (reference ships no wgs reads); "
                                 "reads->env is the genome_scale metric")}))
    print(json.dumps({"metric": "bfs_node_expansions_per_s",
                      "value": round(n / dt, 1), "unit": "expansions/s",
                      "engine": "host-native", "workload": "wiki(deep-narrow)"}))
    print(json.dumps({"metric": "bfs_neighbor_probes_per_s",
                      "value": round(8 * n / dt, 1), "unit": "probes/s",
                      "engine": "host-native", "workload": "wiki(deep-narrow)"}))
    sys.stdout.flush()


def _np_window_codes(seq_codes, k: int):
    """(N,) nucleotide codes -> (N-k+1,) forward 2-bit window codes, numpy."""
    import numpy as np
    win = np.lib.stride_tricks.sliding_window_view(
        seq_codes.astype(np.int64), k)
    pw = (np.int64(1) << (2 * np.arange(k - 1, -1, -1, dtype=np.int64)))
    return win @ pw


def _np_canonical(fw, k: int):
    import numpy as np
    # revcomp of a packed code: complement (3-c) each 2-bit field, reverse
    # field order -- do it from the forward codes by field extraction
    rc = np.zeros_like(fw)
    tmp = fw.copy()
    for _ in range(k):
        rc = (rc << 2) | (3 - (tmp & 3))
        tmp >>= 2
    return np.minimum(fw, rc)


def phase_bfs_device() -> None:
    """Device-vs-host BFS SWEEP on identical workloads.

    Two workloads, dispersed seeds, radius 50:
      dispersed: 400K-kmer map,   4 096 seeds (host + dense + probe)
      flood:       2M-kmer map, 500 000 seeds (host + dense).
    Engines: host = native C++ FIFO (the CLI default); dense = precomputed
    sort-merge-join adjacency + bitmap layers (ops/bfs_dense.py); probe =
    legacy open-addressing gather rounds (ops/bfs_device.py). All visited
    sets are asserted EQUAL before any number is printed.

    Staging is pure vectorized numpy.
    """
    import numpy as np
    import metacherchant_tpu  # noqa: F401
    import jax.numpy as jnp

    from metacherchant_tpu.kmer_map import KmerMap
    from metacherchant_tpu.algo.environment import bfs_fifo

    k = 31
    radius = 50

    def stage(G, n_seeds):
        rng = np.random.default_rng(0)
        gcodes = rng.integers(0, 4, size=G).astype(np.int64)
        fw = _np_window_codes(gcodes, k)
        ukeys = np.unique(_np_canonical(fw, k))
        kmap = KmerMap.from_pairs(ukeys, np.ones(ukeys.size, np.int64))
        seed_pos = rng.choice(G - k, size=n_seeds, replace=False)
        return kmap, np.unique(fw[seed_pos]), ukeys.size

    def sweep(tag, G, n_seeds, with_probe):
        kmap, seeds, n_keys = stage(G, n_seeds)
        log(f"bfs {tag} workload: map {n_keys} kmers, {seeds.size} seeds")
        t0 = time.perf_counter()
        res_h = bfs_fifo(seeds.tolist(), kmap, k, 1, 0, radius, None)
        dt_h = time.perf_counter() - t0
        nh = int(res_h.visited.size)
        log(f"  host: {nh} kmers {dt_h:.3f}s")
        print(json.dumps({
            "metric": f"bfs_node_expansions_per_s_host_{tag}",
            "value": round(nh / dt_h, 1), "unit": "expansions/s",
            "engine": "host-native",
            "workload": f"{tag}(map={n_keys},seeds={seeds.size},r={radius})"}))
        sys.stdout.flush()

        from metacherchant_tpu.ops.bfs_dense import _graph_of, dense_bfs
        t0 = time.perf_counter()
        g = _graph_of(kmap, k)
        int(g.adj[123, 0])
        t_build = time.perf_counter() - t0
        elig = g.eligible(1)
        sd, _ = g.seed_vector(seeds)
        sd = jnp.asarray(sd)

        def one_dense():
            t0 = time.perf_counter()
            _, count, _ = dense_bfs(g.adj, elig, sd, jnp.int32(radius), 0)
            nn = int(count)
            return time.perf_counter() - t0, nn

        t_first, nn = one_dense()
        assert nn == nh, (nn, nh)  # set equality before any number prints
        t_dense = min(one_dense()[0] for _ in range(2))
        log(f"  dense: build {t_build:.3f}s traverse {t_dense:.3f}s "
            f"(first {t_first:.1f}s)")
        print(json.dumps({
            "metric": f"bfs_dense_device_s_{tag}",
            "value": round(t_dense, 3), "unit": "s", "engine": "device-dense",
            "build_s": round(t_build, 3), "n_visited": nn,
            "host_same_workload_s": round(dt_h, 3)}))
        sys.stdout.flush()

        if with_probe:
            from metacherchant_tpu.ops.bfs_device import device_bfs, SENTINEL
            from metacherchant_tpu.ops.hashtable import DeviceHashTable
            table = DeviceHashTable.from_kmer_map(kmap)
            scap = 1 << int(np.ceil(np.log2(seeds.size + 1)))
            seeds_pad = np.full(scap, SENTINEL, np.int64)
            seeds_pad[: seeds.size] = seeds
            seeds_dev = jnp.asarray(seeds_pad)
            visited_log2 = int(np.ceil(np.log2(2 * n_keys / 0.25 + 2)))

            def one_probe():
                t0 = time.perf_counter()
                _, count, ov = device_bfs(
                    seeds_dev, table.tkeys, table.tcnts, 1, radius, k, 0,
                    1 << 14, visited_log2)
                nn = int(count)
                return time.perf_counter() - t0, nn

            t_first, nn = one_probe()
            assert nn == nh, (nn, nh)
            t_probe = min(one_probe()[0] for _ in range(2))
            log(f"  probe: traverse {t_probe:.3f}s (first {t_first:.1f}s)")
            print(json.dumps({
                "metric": f"bfs_probe_device_s_{tag}",
                "value": round(t_probe, 3), "unit": "s",
                "engine": "device-probe", "n_visited": nn,
                "host_same_workload_s": round(dt_h, 3)}))
            sys.stdout.flush()
        return nh, dt_h

    sweep("dispersed", 400_000, 4_096, with_probe=True)
    sweep("flood500k", 2_000_000, 500_000, with_probe=False)


def phase_bfs_genome() -> None:
    """reads -> env.txt END TO END at genome scale, on the default CLI path:
    native C++ parse -> device sort-engine counting -> native C++ FIFO BFS ->
    contraction -> writers, wall-clock to graph.txt (the wiki fixpoint
    metric skips counting entirely). Workload: EXACTLY
    tests/test_genome_scale.py's --
    reads synthesized from the reference's checked-in Salmonella genome
    (288kb over 3 records), 25x coverage, 0.8% substitution errors: ~48K
    reads, ~1.5M distinct k-mers (mostly error k-mers -- that is what makes
    the map genome-scale), ~94K-kmer environment. Reference anchor:
    src/tools/EnvironmentFinderMain.java:186-243 (runImpl = load+BFS+write).
    """
    # pin the counting geometry to the "small" bench rung (2^23 lanes,
    # store 2^21 > 1.5M distinct so no growth; see GEOMETRY)
    os.environ.setdefault("MC_SORT_BUF_LANES", str((1 << 23) - (1 << 21)))
    os.environ.setdefault("MC_SORT_STORE_LANES", str(1 << 21))
    # 150 bp reads in a (B, 256) batch waste ~40% of every consolidation on
    # SENTINEL lanes; pack at L=160 instead (counting.py MC_COUNT_MAX_LEN),
    # batch 4032 so 12 fills hit 100.0% of the 2^23-2^21 append buffer
    os.environ.setdefault("MC_COUNT_MAX_LEN", "160")
    os.environ.setdefault("MC_COUNT_BATCH", "4032")
    import numpy as np
    import metacherchant_tpu  # noqa: F401
    from metacherchant_tpu.runner import main as runner_main

    src = "/root/reference/Hi-C_pipline/example/Salmonella_source"
    if not os.path.isdir(src):
        log("Salmonella source not mounted; skipping genome phase")
        return
    import tempfile
    tmp = tempfile.mkdtemp(prefix="mc_bench_genome_")
    k, read_len, coverage, err = 31, 150, 25, 0.008

    seqs = []
    for fname in ("salmonella.fasta", "salmonella_pls.fasta"):
        cur = []
        with open(os.path.join(src, fname)) as f:
            for line in f:
                if line.startswith(">"):
                    if cur:
                        seqs.append("".join(cur))
                        cur = []
                else:
                    cur.append(line.strip())
        if cur:
            seqs.append("".join(cur))

    rng = np.random.default_rng(42)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    reads_path = os.path.join(tmp, "reads.fastq")
    t0 = time.perf_counter()
    with open(reads_path, "w") as f:
        i = 0
        for g in seqs:
            arr = np.frombuffer(g.encode(), np.uint8)
            n_reads = len(g) * coverage // read_len
            starts = rng.integers(0, len(arr) - read_len, size=n_reads)
            for s in starts:
                r = arr[s:s + read_len].copy()
                errs = np.flatnonzero(rng.random(read_len) < err)
                r[errs] = alphabet[rng.integers(0, 4, size=errs.size)]
                f.write(f"@r{i}\n{r.tobytes().decode()}\n+\n"
                        f"{'I' * read_len}\n")
                i += 1
    gene_path = os.path.join(tmp, "gene.fasta")
    with open(gene_path, "w") as f:
        f.write(f">salmgene\n{seqs[0][50000:52000]}\n")
    log(f"genome workload staged: {i} reads in "
        f"{time.perf_counter() - t0:.1f}s")

    def run_once(tag):
        t0 = time.perf_counter()
        runner_main([
            "-t", "environment-finder", "-k", str(k), "-i", reads_path,
            "--seq", gene_path, "-o", os.path.join(tmp, "out_" + tag),
            "--coverage", "2", "--maxradius", "100000",
            "--work-dir", os.path.join(tmp, "wd_" + tag), "--force"])
        dt = time.perf_counter() - t0
        outdir = os.path.join(tmp, "out_" + tag)
        (sub,) = os.listdir(outdir)
        with open(os.path.join(outdir, sub, "graph.txt")) as f:
            n_env = sum(1 for _ in f)
        return dt, n_env

    dt1, n_env = run_once("a")   # includes compile-cache loads
    log(f"genome-scale pass 1: {dt1:.2f}s, env {n_env} kmers")
    dt2, _ = run_once("b")       # warm pass
    dt = min(dt1, dt2)
    log(f"genome-scale pass 2: {dt2:.2f}s")
    print(json.dumps({"metric": "time_to_env_txt_genome_scale",
                      "value": round(dt, 2), "unit": "s",
                      "engine": "default-cli-path",
                      "reads": int(i), "env_kmers": int(n_env)}))
    sys.stdout.flush()


def phase_classify() -> None:
    """reads-classifier end-to-end throughput (host path: native whole-read
    parse + probe-table lookups + vectorized blob FASTQ bins). 200K reads
    (100K pairs, half in-graph) -- a scaled-down scripts/bench_classify.py
    so the number lands in the driver artifact. Reference:
    src/tools/ReadsClassifier.java:138-223 (one task per pair, per-record
    I/O)."""
    import numpy as np
    import tempfile
    import metacherchant_tpu  # noqa: F401
    from metacherchant_tpu.runner import main as runner_main

    n_pairs, read_len, k = 100_000, 100, 31
    tmp = tempfile.mkdtemp(prefix="mc_bench_classify_")
    rng = np.random.default_rng(0)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    genome = alphabet[rng.integers(0, 4, size=400_000)]

    def synth(path, seed):
        r = np.random.default_rng(seed)
        starts = r.integers(0, genome.size - read_len, size=n_pairs)
        in_graph = r.random(n_pairs) < 0.5
        with open(path, "w") as f:
            for i in range(n_pairs):
                s = (genome[starts[i]:starts[i] + read_len] if in_graph[i]
                     else alphabet[r.integers(0, 4, size=read_len)])
                f.write(f"@r{i}\n{s.tobytes().decode()}\n+\n"
                        f"{'I' * read_len}\n")

    synth(os.path.join(tmp, "r1.fastq"), 1)
    synth(os.path.join(tmp, "r2.fastq"), 2)
    os.environ["MC_HOST_COUNT"] = "1"  # graph build is not what we measure
    runner_main(["-t", "kmer-counter", "-k", str(k),
                 "-i", os.path.join(tmp, "r1.fastq"),
                 "--work-dir", os.path.join(tmp, "wd_kc")])
    kbin = os.path.join(tmp, "wd_kc", "kmers", "r1.kmers.bin")
    log(f"classify workload staged: {2 * n_pairs} reads")

    t0 = time.perf_counter()
    runner_main(["-t", "reads-classifier", "-k", str(k), "-i", kbin,
                 "-r", os.path.join(tmp, "r1.fastq"),
                 os.path.join(tmp, "r2.fastq"),
                 "-o", os.path.join(tmp, "out"),
                 "--work-dir", os.path.join(tmp, "wd_rc")])
    dt = time.perf_counter() - t0
    total = 2 * n_pairs
    log(f"classified {total} reads in {dt:.1f}s")
    print(json.dumps({"metric": "classify_reads_per_s",
                      "value": round(total / dt, 1), "unit": "reads/s",
                      "engine": "host-vectorized", "reads": total}))
    sys.stdout.flush()


def main() -> int:
    if "--phase" in sys.argv:
        which = sys.argv[sys.argv.index("--phase") + 1]
        geom = (sys.argv[sys.argv.index("--geom") + 1]
                if "--geom" in sys.argv else "default")
        if which == "bfs-host":
            phase_bfs_host()
            return 0
        if which == "bfs-device":
            phase_bfs_device()
            return 0
        if which == "bfs-genome":
            phase_bfs_genome()
            return 0
        if which == "classify":
            phase_classify()
            return 0
        phase_main(which, geom)
        return 0
    return parent()


if __name__ == "__main__":
    sys.exit(main())
