"""End-to-end reads-classifier throughput on a >=1M-read synthetic.

Builds a kmers.bin graph from a 400kb genome, synthesizes N paired reads
(half in-graph, half random so every bin gets traffic), and times the FULL
CLI tool (load graph -> stream pairs -> vectorized find_reads -> vectorized
bin routing -> vectorized blob FASTQ writes).

Usage: JAX_PLATFORMS=cpu python scripts/bench_classify.py [n_pairs]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 500_000
    k, read_len = 31, 100
    import tempfile
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
                if in_graph[i]:
                    s = genome[starts[i]:starts[i] + read_len]
                else:
                    s = alphabet[r.integers(0, 4, size=read_len)]
                f.write(f"@r{i}\n{s.tobytes().decode()}\n+\n"
                        f"{'I' * read_len}\n")

    t0 = time.perf_counter()
    synth(os.path.join(tmp, "r1.fastq"), 1)
    synth(os.path.join(tmp, "r2.fastq"), 2)
    log(f"staged {2 * n_pairs} reads in {time.perf_counter() - t0:.1f}s")

    from metacherchant_tpu.runner import main as runner_main
    os.environ["MC_HOST_COUNT"] = "1"  # graph build is not what we measure
    t0 = time.perf_counter()
    runner_main([
        "-t", "kmer-counter", "-k", str(k),
        "-i", os.path.join(tmp, "r1.fastq"),
        "--work-dir", os.path.join(tmp, "wd_kc")])
    log(f"graph built in {time.perf_counter() - t0:.1f}s")
    kbin = os.path.join(tmp, "wd_kc", "kmers", "r1.kmers.bin")

    t0 = time.perf_counter()
    runner_main([
        "-t", "reads-classifier", "-k", str(k), "-i", kbin,
        "-r", os.path.join(tmp, "r1.fastq"), os.path.join(tmp, "r2.fastq"),
        "-o", os.path.join(tmp, "out"),
        "--work-dir", os.path.join(tmp, "wd_rc")])
    dt = time.perf_counter() - t0
    total = 2 * n_pairs
    print(f"RESULT classify {total} reads in {dt:.1f}s "
          f"({total / dt / 1e3:.0f}K reads/s)", flush=True)


if __name__ == "__main__":
    main()
