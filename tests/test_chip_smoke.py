"""chip_smoke.py off the card: it refuses to run, and its references agree
with the repository's own extraction on small inputs."""
import os
import shutil
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_refuses_without_gpu():
    proc = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_refuses_without_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("k", [3, 16, 31])
def test_exact_reference_matches_scan(k):
    from metacherchant_tpu.ops.kmers import exact_canonical_kmers
    reads = np.random.default_rng(k).integers(0, 4, (40, 60)).astype(np.uint8)
    keys, _ = exact_canonical_kmers(jnp.asarray(reads.astype(np.int32)), k)
    want = np.asarray(keys)[:, k - 1:].ravel()
    assert np.array_equal(chip_smoke.exact_keys_np(reads, k), want)


@pytest.mark.parametrize("hasher", ["poly", "fnv1a"])
def test_hashed_reference_matches_device_hash(hasher):
    from metacherchant_tpu.ops.kmers import hash_canonical_kmers
    k = 55
    reads = np.random.default_rng(2).integers(0, 4, (20, 80)).astype(np.uint8)
    keys, _ = hash_canonical_kmers(jnp.asarray(reads.astype(np.int32)), k,
                                   hasher)
    want = np.asarray(keys)[:, k - 1:].ravel()
    assert np.array_equal(chip_smoke.hashed_keys_np(reads, k, hasher), want)


def test_community_reads_and_fastq(tmp_path):
    """Mates come from opposite strands of one genome, the FASTQ round-trips
    through the repository's reader, and genes are genome substrings."""
    from metacherchant_tpu.io.readers import iter_reads_split
    rng = np.random.default_rng(0)
    genomes, cover, r1, r2 = chip_smoke.make_community(
        rng, 3, 5_000, 6_000, 200, err=0.0)
    assert r1.shape == r2.shape == (200, chip_smoke.READ_LEN)
    def seq(codes):
        return "".join("AGCT"[c] for c in codes)

    text = [seq(g) for g in genomes]
    for a, b in zip(r1[:20], r2[:20]):
        fw_a, rc_b = seq(a), seq(3 - b[::-1])
        fw_b, rc_a = seq(b), seq(3 - a[::-1])
        assert any((fw_a in t and rc_b in t) or (fw_b in t and rc_a in t)
                   for t in text)
    path = str(tmp_path / "r.fastq")
    chip_smoke.write_fastq(path, r1)
    parsed = list(iter_reads_split(path))
    assert len(parsed) == 200
    assert np.array_equal(np.stack(parsed), r1.astype(np.int8))
    genes = chip_smoke.pick_genes(rng, genomes, cover, 2, 0, per_genome=1,
                                  length=100, min_cover=0)
    assert len(genes) == 2
    assert all(any("".join("AGCT"[c] for c in g) in t for t in text)
               for g in genes)
