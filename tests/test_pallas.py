"""Pallas Triton extraction kernel (ops/pallas_kmers.py) against the XLA scan.

The kernel runs in interpret mode here; its compiled form runs on the card
(the `gpu` test below, and every exact-regime count of chip_smoke.py)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from metacherchant_tpu.ops import kmers, pallas_kmers
from metacherchant_tpu.ops.kmers import (
    SENTINEL, canonical_kmers, exact_canonical_kmers, window_keys)


def _codes(seed, B, L, n_rate=0.05):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((B, L)) < n_rate, -1,
                    rng.integers(0, 4, (B, L))).astype(np.int32)


def _kernel(codes, k, **kw):
    return np.asarray(pallas_kmers.exact_keys_position_major(
        jnp.asarray(codes), k, interpret=True, **kw))


def _scan(codes, k):
    return np.asarray(exact_canonical_kmers(jnp.asarray(codes), k)[0])


@pytest.mark.parametrize("k", [3, 15, 16, 17, 31])
def test_kernel_matches_xla_scan(k):
    codes = _codes(k, 200, 90)
    assert np.array_equal(_kernel(codes, k).T, _scan(codes, k))


def test_kernel_n_splits_and_short_rows():
    """N runs, rows shorter than k, an all-padding row and a row of exactly
    k bases: every window touching a non-base is SENTINEL."""
    k = 21
    codes = _codes(1, 64, 70, n_rate=0.0)
    codes[0, 30:33] = -1          # N run mid-read
    codes[1, 20:] = -1            # short row (20 < k bases)
    codes[2, :] = -1              # padding row
    codes[3, k:] = -1             # exactly one window
    codes[4, ::10] = -1           # N every 10 bases: no window fits
    got = _kernel(codes, k).T
    assert np.array_equal(got, _scan(codes, k))
    assert (got[1] == SENTINEL).all() and (got[2] == SENTINEL).all()
    assert (got[4] == SENTINEL).all()
    assert (got[3] != SENTINEL).sum() == 1


@pytest.mark.parametrize("B,block", [(1, 64), (130, 64), (300, 128)])
def test_kernel_pads_reads_to_whole_blocks(B, block):
    codes = _codes(B, B, 50)
    got = _kernel(codes, 17, block_reads=block)
    assert got.shape == (50, B)
    assert np.array_equal(got.T, _scan(codes, 17))


@pytest.mark.parametrize("seg_len", [8, 32, 100])
def test_kernel_segments_equal_one_pass(seg_len):
    """Segments shorter than the k-1 warm-up, uneven and a single segment
    all give the keys of one pass over the read."""
    codes = _codes(seg_len, 64, 100)
    assert np.array_equal(_kernel(codes, 31, seg_len=seg_len).T,
                          _scan(codes, 31))


def test_kernel_output_is_position_major():
    codes = _codes(5, 32, 40)
    got = _kernel(codes, 11)
    ref = _scan(codes, 11)
    assert got.shape == (40, 32)
    assert got[17, 3] == ref[3, 17]


def _spy(monkeypatch):
    calls = []
    real = pallas_kmers.exact_keys_position_major

    def spy(codes, k, **kw):
        calls.append(kw)
        return real(codes, k, interpret=True)

    monkeypatch.setattr(pallas_kmers, "exact_keys_position_major", spy)
    return calls


def test_gpu_backend_routes_exact_regime_to_kernel(monkeypatch):
    """On a GPU backend the exact regime runs the compiled kernel (no
    interpret flag), the hashed regime does not, and both entry points give
    the scan's keys."""
    calls = _spy(monkeypatch)
    monkeypatch.setattr(kmers.jax, "default_backend", lambda: "gpu")
    codes = _codes(7, 96, 48)
    keys, ok = map(np.asarray, canonical_kmers(jnp.asarray(codes), 21, None))
    ref = _scan(codes, 21)
    assert np.array_equal(keys, ref) and np.array_equal(ok, ref != SENTINEL)
    flat = np.asarray(window_keys(jnp.asarray(codes), 21, None))
    assert np.array_equal(np.sort(flat), np.sort(ref[:, 20:].ravel()))
    assert len(calls) == 2 and not any(kw.get("interpret") for kw in calls)
    canonical_kmers(jnp.asarray(codes), 21, "poly")
    assert len(calls) == 2


def test_cpu_backend_routes_to_xla_scan(monkeypatch):
    calls = _spy(monkeypatch)
    assert jax.default_backend() == "cpu"
    codes = _codes(8, 16, 40)
    flat = np.asarray(window_keys(jnp.asarray(codes), 15, None))
    assert np.array_equal(flat, _scan(codes, 15)[:, 14:].ravel())
    assert calls == []


@pytest.mark.gpu
def test_kernel_compiled_matches_xla_scan(gpu):
    """The compiled kernel at the CLI's batch geometry (4096 x 256)."""
    codes = _codes(9, 4096, 256, n_rate=0.01)
    got = np.asarray(pallas_kmers.exact_keys_position_major(
        jnp.asarray(codes), 31))
    assert np.array_equal(got.T, _scan(codes, 31))
