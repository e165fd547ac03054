"""Dense-adjacency device BFS (ops/bfs_dense.py) vs the host layered engine."""
import numpy as np
import pytest

from metacherchant_tpu.counting import count_sequences_host
from metacherchant_tpu.algo.environment import (
    bfs_layered, seed_codes_of_sequences)
from metacherchant_tpu.ops.bfs_dense import (
    DenseDBG, run_dense_bfs, _graph_of)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), size=3000))
    k = 15
    kmap = count_sequences_host([genome], k)
    gene = genome[1000:1100]
    seeds = np.array(seed_codes_of_sequences([gene], k, kmap, 1), np.int64)
    return kmap, seeds, k


@pytest.mark.parametrize("direction", [-1, 1, 0])
@pytest.mark.parametrize("max_radius", [0, 5, 50, None])
def test_dense_bfs_matches_layered(setup, direction, max_radius):
    kmap, seeds, k = setup
    ref = bfs_layered(seeds, kmap, k, 1, direction, max_radius)
    got = run_dense_bfs(seeds, kmap, k, 1, direction, max_radius)
    assert np.array_equal(np.sort(ref.visited), got)


def test_dense_bfs_coverage_threshold(setup):
    kmap, seeds, k = setup
    got = run_dense_bfs(seeds, kmap, k, 2, 0, None)
    ref = bfs_layered(seeds, kmap, k, 2, 0, None)
    assert np.array_equal(np.sort(ref.visited), got)


def test_dense_graph_cached_on_map(setup):
    kmap, seeds, k = setup
    g1 = _graph_of(kmap, k)
    g2 = _graph_of(kmap, k)
    assert g1 is g2


def test_adjacency_against_host_neighbors(setup):
    """Every adjacency entry equals the host-computed eligible neighbor id."""
    from metacherchant_tpu.algo.environment import neighbors_codes
    from metacherchant_tpu.dna import revcomp_codes_np
    kmap, _, k = setup
    g = _graph_of(kmap, k)
    adj = np.asarray(g.adj)
    keys = g.keys_host
    n = g.n
    # host truth for a sample of oriented nodes
    rng = np.random.default_rng(1)
    sample = rng.integers(0, 2 * n, size=200)
    for oid in sample:
        code = keys[oid >> 1]
        if oid & 1:
            code = revcomp_codes_np(np.array([code], np.int64), k)[0]
        left = neighbors_codes(np.array([code], np.int64), k, -1)[0]
        right = neighbors_codes(np.array([code], np.int64), k, 1)[0]
        nbrs = np.concatenate([left, right])
        canon = np.minimum(nbrs, revcomp_codes_np(nbrs, k))
        pos = np.searchsorted(keys, canon)
        pos_c = np.minimum(pos, n - 1)
        present = keys[pos_c] == canon
        expect = np.where(present, 2 * pos_c + (nbrs != canon), g.pad_id)
        assert np.array_equal(adj[oid], expect), oid


def test_dense_bfs_multiseed_dispersed():
    """Wide dispersed-seed flood (the engine's target regime) matches the
    layered engine on a branchy multi-fragment graph."""
    rng = np.random.default_rng(7)
    k = 15
    frags = ["".join(rng.choice(list("ACGT"), size=400)) for _ in range(8)]
    kmap = count_sequences_host(frags, k)
    seeds = []
    for f in frags[:4]:
        seeds.extend(seed_codes_of_sequences([f[i:i + k]], k, kmap, 1)
                     for i in range(0, 300, 37))
    seeds = np.array([s for sub in seeds for s in sub], np.int64)
    for direction in (-1, 1, 0):
        ref = bfs_layered(seeds, kmap, k, 1, direction, 10)
        got = run_dense_bfs(seeds, kmap, k, 1, direction, 10)
        assert np.array_equal(np.sort(ref.visited), got)


def test_dense_bfs_out_of_map_seeds():
    """min_occ=0 can admit seeds absent from the map; the dense engine's
    two-pass union must still match the layered engine."""
    rng = np.random.default_rng(3)
    k = 15
    genome = "".join(rng.choice(list("ACGT"), size=1000))
    kmap = count_sequences_host([genome], k)
    in_map = np.array(seed_codes_of_sequences([genome[100:130]], k, kmap, 1),
                      np.int64)
    # an absent oriented code: flip bits until not in the map
    from metacherchant_tpu.dna import revcomp_codes_np
    absent = None
    for cand in range(1 << 10):
        canon = min(cand, int(revcomp_codes_np(
            np.array([cand], np.int64), k)[0]))
        if kmap.get_many(np.array([canon], np.int64))[0] < 0:
            absent = cand
            break
    assert absent is not None
    seeds = np.concatenate([in_map, [absent]]).astype(np.int64)
    for mr in (0, 3, None):
        ref = bfs_layered(seeds, kmap, k, 0, 0, mr)
        got = run_dense_bfs(seeds, kmap, k, 0, 0, mr)
        assert np.array_equal(np.sort(ref.visited), got)


def test_dense_rejects_large_k():
    with pytest.raises(ValueError):
        DenseDBG(np.array([0], np.int64), np.array([1], np.int64), 33)


def test_join_lane_budget_covers_huge_maps():
    """Every map gets a budget ABOVE the store, also at and above the lane
    cap (where 8*Np would be capped to Np or below)."""
    from metacherchant_tpu.ops.bfs_dense import _join_lane_budget
    for np_lanes in (1 << 10, 1 << 19, 1 << 21, 1 << 25, 1 << 28, 1 << 29):
        total = _join_lane_budget(np_lanes)
        assert total > np_lanes, np_lanes
        assert total <= max(8 * np_lanes, 2 * np_lanes)


def test_dense_rejects_negative_min_occ(setup):
    """Negative coverage admits ABSENT k-mers in the host engines; the dense
    engine has no node ids for them and must refuse loudly."""
    kmap, seeds, k = setup
    with pytest.raises(ValueError):
        run_dense_bfs(seeds, kmap, k, -1, 0, 5)
