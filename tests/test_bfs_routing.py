"""BFS engine auto-routing policy (algo/environment.route_device_bfs)."""
import numpy as np
import pytest

from metacherchant_tpu.algo.environment import route_device_bfs


def test_order_dependent_modes_always_host(monkeypatch):
    monkeypatch.setenv("MC_DEVICE_BFS", "1")
    assert not route_device_bfs(10_000, 100, max_kmers=5, trim=False)
    assert not route_device_bfs(10_000, 100, max_kmers=None, trim=True)


def test_force_flags(monkeypatch):
    monkeypatch.setenv("MC_DEVICE_BFS", "1")
    assert route_device_bfs(1, None, None, False)
    monkeypatch.setenv("MC_DEVICE_BFS", "0")
    assert not route_device_bfs(1_000_000, 10, None, False)


def test_auto_route_demoted_by_default(monkeypatch):
    """The device engines are opt-in: no regime where they beat the host
    C++ FIFO has been measured on the GPU. Without an explicit
    MC_DEVICE_BFS_MIN_SEEDS opt-in, every shape routes host."""
    monkeypatch.delenv("MC_DEVICE_BFS", raising=False)
    monkeypatch.delenv("MC_DEVICE_BFS_MIN_SEEDS", raising=False)
    assert not route_device_bfs(3000, 100_000, None, False)
    assert not route_device_bfs(100_000, None, None, False)
    # the formerly auto-routed massive flood now also stays host
    assert not route_device_bfs(600_000, 1000, None, False)
    assert not route_device_bfs(5000, 1000, None, False)
    assert not route_device_bfs(100, 1000, None, False)


def test_auto_route_thresholds_env(monkeypatch):
    monkeypatch.delenv("MC_DEVICE_BFS", raising=False)
    monkeypatch.setenv("MC_DEVICE_BFS_MIN_SEEDS", "10")
    monkeypatch.setenv("MC_DEVICE_BFS_MAX_RADIUS", "50")
    assert route_device_bfs(10, 50, None, False)
    assert not route_device_bfs(9, 50, None, False)
    assert not route_device_bfs(10, 51, None, False)


def test_auto_routed_device_equals_host(monkeypatch):
    """End-to-end: an auto-routed wide-shallow run must equal the host run."""
    from metacherchant_tpu.counting import count_sequences_host
    from metacherchant_tpu.algo.environment import build_environment
    from metacherchant_tpu.dna import reverse_complement

    k = 15
    rng = np.random.default_rng(33)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    reads = []
    for _ in range(600):
        i = int(rng.integers(0, len(genome) - 60))
        r = genome[i:i + 60]
        if rng.random() < 0.5:
            r = reverse_complement(r)
        reads.append(r)
    kmap = count_sequences_host(reads, k)
    gene = genome[500:2500]  # ~2k seeds

    monkeypatch.setenv("MC_DEVICE_BFS", "0")
    host = build_environment([gene], k, kmap, min_occ=1,
                             both_directions=False, max_radius=20,
                             max_kmers=None, trim=False)
    monkeypatch.delenv("MC_DEVICE_BFS", raising=False)
    monkeypatch.setenv("MC_DEVICE_BFS_MIN_SEEDS", "64")
    from metacherchant_tpu.algo.environment import route_device_bfs as route
    assert route(len(gene) - k + 1, 20, None, False)
    dev = build_environment([gene], k, kmap, min_occ=1,
                            both_directions=False, max_radius=20,
                            max_kmers=None, trim=False)
    assert np.array_equal(host.codes, dev.codes)
    assert np.array_equal(host.counts, dev.counts)
