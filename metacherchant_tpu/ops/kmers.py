"""Device (JAX) rolling canonical k-mer extraction over batched reads.

Replaces the reference's per-read rolling iterator + per-kmer map insert hot loop
(itmo:dna/kmers/ShortKmer.java:68-71,104-150; src/io/IOUtils.java:200-214) with a
batched lax.scan over read positions: every step advances all reads in the batch
by one base with elementwise bit ops. On the GPU the exact regime runs the
Pallas Triton kernel of ops/pallas_kmers.py instead.

Keying regimes (src/tools/EnvironmentFinderMain.java:127-154):
- exact (k <= 31): canonical key = signed min(fw, rc) of the 2-bit packed codes
  (itmo:utils/KmerUtils.java:59-61; fw/rc update per itmo:dna/kmers/ShortKmer.java:68-71)
- poly (k > 31 or --forcehash): base-5 polynomial with seed 1 over codes, rc uses
  3^code in forward order of the rc string; key = signed min(fwHash, rcHash),
  arithmetic wrapping mod 2^64 / Java long semantics (src/utils/PolynomialHash.java:7-28)
- fnv1a: FNV-1a with offset basis 14695981039346656037 and prime 1099511628211
  (src/utils/FNV1AHash.java:8-42)

Input layout: (B, L) int32 code matrix, entries 0..3, padding = -1. Position j
emits the key of window [j-k+1, j] once j >= k-1 and the trailing run of valid
codes is >= k. Invalid positions emit SENTINEL (int64 max).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

MASK64 = (1 << 64) - 1
SENTINEL = np.int64(np.iinfo(np.int64).max)

FNV_OFFSET_BASIS = 14695981039346656037
FNV_PRIME = 1099511628211
POLY_BASE = 5


def _i64(x: int) -> np.int64:
    """Python int (mod 2^64) -> wrapped int64 constant."""
    x &= MASK64
    if x >= 1 << 63:
        x -= 1 << 64
    return np.int64(x)


def _valid_window_mask(codes: jax.Array, k: int) -> jax.Array:
    """(B, L) bool: True at column j iff codes[:, j-k+1..j] are all in 0..3.

    run[j] = j - max_{i<=j}(i if invalid else -1), via an associative cummax.
    """
    B, L = codes.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    z = jnp.where(codes < 0, col, -1)
    last_bad = jax.lax.associative_scan(jnp.maximum, z, axis=1)
    run = col - last_bad
    return run >= k


@functools.partial(jax.jit, static_argnames=("k",))
def exact_canonical_kmers(codes: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """(B, L) int32 codes -> ((B, L) int64 canonical keys, (B, L) bool validity).

    Key at column j covers window [j-k+1, j]. Scan carries (fw, rc) per read;
    semantics of ShortKmer.shiftRight (itmo:dna/kmers/ShortKmer.java:68-71).
    """
    B, L = codes.shape
    mask = _i64((1 << (2 * k)) - 1)
    shift_hi = 2 * k - 2

    def step(carry, col):
        fw, rc = carry
        cc = jnp.where(col >= 0, col.astype(jnp.int64), 0)
        fw = ((fw << 2) | cc) & mask
        rc = (rc >> 2) | ((3 - cc) << shift_hi)
        return (fw, rc), jnp.minimum(fw, rc)

    zeros = jnp.zeros((B,), jnp.int64)
    _, keys = jax.lax.scan(step, (zeros, zeros), codes.T)
    ok = _valid_window_mask(codes, k)
    return jnp.where(ok, keys.T, SENTINEL), ok


def _poly_windowed_hash(codes: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """O(B*L) closed-form polynomial window hash (vs the O(k*B*L) loop).

    The Java hash (src/utils/PolynomialHash.java:19-28) is, with seed 1 and
    arithmetic mod 2^64 (Java long wrap):
        fw(i) = 5^k + sum_t code[i+t]   * 5^(k-1-t)
        rc(i) = 5^k + sum_u (3^code[i+u]) * 5^u
    5 is odd, hence invertible mod 2^64, so both are differences of prefix
    sums: with P(j) = sum_{m<j} code[m]*inv5^m and Q(j) = sum_{m<j}
    (3^code[m])*5^m,
        fw(i) = 5^k + 5^(i+k-1) * (P(i+k) - P(i))
        rc(i) = 5^k + inv5^i    * (Q(i+k) - Q(i))
    One log-depth cumsum per direction instead of a k-step sequential loop;
    int64 two's-complement wrap in XLA is bit-identical to mod-2^64.
    Exactness vs the per-window oracle is pinned in tests/test_kmers.py.
    """
    B, L = codes.shape
    cpad = jnp.where(codes < 0, 0, codes).astype(jnp.int64)
    inv5 = pow(POLY_BASE, -1, 1 << 64)
    pow5_np = np.empty(L + 1, np.uint64)
    invp_np = np.empty(L + 1, np.uint64)
    p = q = 1
    for m in range(L + 1):
        pow5_np[m], invp_np[m] = p, q
        p = (p * POLY_BASE) & MASK64
        q = (q * inv5) & MASK64
    pow5 = jnp.asarray(pow5_np.view(np.int64))
    invp = jnp.asarray(invp_np.view(np.int64))
    comp = cpad ^ jnp.int64(3)
    zero = jnp.zeros((B, 1), jnp.int64)
    P = jnp.concatenate([zero, jnp.cumsum(cpad * invp[:L], axis=1)], axis=1)
    Q = jnp.concatenate([zero, jnp.cumsum(comp * pow5[:L], axis=1)], axis=1)
    p5k = _i64(pow(POLY_BASE, k, 1 << 64))
    i = np.arange(L)                       # window starts (valid i <= L-k)
    i_end = np.minimum(i + k, L)           # clipped: invalid windows masked below
    fw = p5k + pow5[np.minimum(i + k - 1, L)] * (P[:, i_end] - P[:, i])
    rc = p5k + invp[i] * (Q[:, i_end] - Q[:, i])
    keys_start = jnp.minimum(fw, rc)
    ok_end = _valid_window_mask(codes, k)
    keys_end = jnp.roll(keys_start, k - 1, axis=1)
    return jnp.where(ok_end, keys_end, SENTINEL), ok_end


def _windowed_hash(codes: jax.Array, k: int, kind: str) -> tuple[jax.Array, jax.Array]:
    """O(k*B*L) per-window hash, vectorized over (B, L).

    For window start i: iterate t = 0..k-1, updating fw with code[i+t] and rc
    with 3^code[i+k-1-t], matching the Java loops character-for-character
    (src/utils/PolynomialHash.java:19-28, src/utils/FNV1AHash.java:33-42).
    FNV-1a's xor-multiply chain has no sliding/prefix form, so only it pays
    the O(k) loop; poly routes through the closed form above.
    """
    if kind == "poly":
        return _poly_windowed_hash(codes, k)
    B, L = codes.shape
    cpad = jnp.where(codes < 0, 0, codes).astype(jnp.int64)
    init = jnp.int64(1) if kind == "poly" else _i64(FNV_OFFSET_BASIS)
    fw = jnp.full((B, L), init, jnp.int64)
    rc = jnp.full((B, L), init, jnp.int64)
    prime = _i64(FNV_PRIME)

    def body(t, fr):
        fw, rc = fr
        cf = jnp.roll(cpad, -t, axis=1)            # code[i + t] at column i
        cr = jnp.roll(cpad, -(k - 1) + t, axis=1)  # code[i + k - 1 - t] at column i
        if kind == "poly":
            fw = fw * POLY_BASE + cf
            rc = rc * POLY_BASE + (3 ^ cr)
        else:
            fw = (fw ^ cf) * prime
            rc = (rc ^ (3 ^ cr)) * prime
        return (fw, rc)

    def body_rc_aligned(t, fr):
        # rc consumes codes in reverse window order: at step t it needs
        # code[i + k - 1 - t]; implemented as a forward roll of (k-1-t).
        return body(t, fr)

    fw, rc = jax.lax.fori_loop(0, k, body_rc_aligned, (fw, rc))
    keys_start = jnp.minimum(fw, rc)  # indexed by window START i
    ok_end = _valid_window_mask(codes, k)  # indexed by window END j = i + k - 1
    keys_end = jnp.roll(keys_start, k - 1, axis=1)
    return jnp.where(ok_end, keys_end, SENTINEL), ok_end


@functools.partial(jax.jit, static_argnames=("k", "hash_name"))
def hash_canonical_kmers(codes: jax.Array, k: int, hash_name: str) -> tuple[jax.Array, jax.Array]:
    """Hashed-regime keys for k of any size. hash_name in {'poly', 'fnv1a'}."""
    if hash_name not in ("poly", "fnv1a"):
        raise ValueError(f"unknown hash {hash_name}")
    return _windowed_hash(codes, k, hash_name)


def _use_gpu_kernel(hasher: str | None) -> bool:
    """Exact-regime extraction runs the Pallas Triton kernel on the GPU
    (ops/pallas_kmers.py); the XLA scan is the CPU path and the oracle."""
    return hasher is None and jax.default_backend() == "gpu"


def canonical_kmers(codes: jax.Array, k: int, hasher: str | None) -> tuple[jax.Array, jax.Array]:
    """Dispatch per the reference regime selection
    (src/tools/EnvironmentFinderMain.java:127-154): hasher None -> exact codes."""
    if _use_gpu_kernel(hasher):
        from .pallas_kmers import exact_keys_position_major
        keys = exact_keys_position_major(codes, k).T
        return keys, keys != SENTINEL
    if hasher is None:
        return exact_canonical_kmers(codes, k)
    return hash_canonical_kmers(codes, k, hasher)


def window_keys(codes: jax.Array, k: int, hasher: str | None) -> jax.Array:
    """1-D keys of every window of a (B, L) batch that ends at column >= k-1,
    in no fixed order (SENTINEL where the window is not all bases).

    The first k-1 key columns of every row are always invalid and are left
    out. The counters only need the multiset, so the GPU kernel's
    position-major keys are taken as they are, with no transpose."""
    if _use_gpu_kernel(hasher):
        from .pallas_kmers import exact_keys_position_major
        return exact_keys_position_major(codes, k)[k - 1:].ravel()
    keys, _ = canonical_kmers(codes, k, hasher)
    return keys[:, k - 1:].ravel()


# ---------------------------------------------------------------------------
# Host (numpy/python) oracle implementations -- tests and small-input paths
# ---------------------------------------------------------------------------

def _signed(x: int) -> int:
    return x - (1 << 64) if x >= (1 << 63) else x


def hash_codes_pair_np(codes: np.ndarray, hasher: str
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Pre-min (fw, rc) hash pair of (N, k) code rows as uint64 bit patterns.

    Exact Java long semantics via uint64 wraparound (fused fw/rc loops,
    src/utils/PolynomialHash.java:19-28, src/utils/FNV1AHash.java:33-42).
    Exposed separately so the scalar sliding-hash BFS can seed its per-state
    (fw, rc) registers."""
    codes = np.asarray(codes, np.uint64)
    n, k = codes.shape
    if hasher == "poly":
        fw = np.ones(n, np.uint64)
        rc = np.ones(n, np.uint64)
    elif hasher == "fnv1a":
        fw = np.full(n, np.uint64(FNV_OFFSET_BASIS & MASK64))
        rc = fw.copy()
    else:
        raise ValueError(hasher)
    prime = np.uint64(FNV_PRIME)
    five = np.uint64(POLY_BASE)
    three = np.uint64(3)
    with np.errstate(over="ignore"):
        for t in range(k):
            cf = codes[:, t]
            cr = codes[:, k - 1 - t] ^ three
            if hasher == "poly":
                fw = fw * five + cf
                rc = rc * five + cr
            else:
                fw = (fw ^ cf) * prime
                rc = (rc ^ cr) * prime
    return fw, rc


def hash_codes_np(codes: np.ndarray, hasher: str) -> np.ndarray:
    """Vectorized canonical hash of (N, k) nucleotide-code rows (host, numpy).

    Per-row result equals hash_str of the row's string: key = signed
    min(fw, rc) (src/utils/AbstractHashFunction.java + the hash classes)."""
    fw, rc = hash_codes_pair_np(codes, hasher)
    return np.minimum(fw.view(np.int64), rc.view(np.int64))


def codes_matrix_of_kmer_strings(kmers: list[str], k: int) -> np.ndarray:
    """(N, k) int8 nucleotide codes of equal-length k-mer strings (host).

    One frombuffer + table lookup instead of per-string Python loops; the
    strings must be plain ACGT (normalized subgraph k-mers always are)."""
    from ..dna import CHAR_TO_CODE
    raw = np.frombuffer("".join(kmers).encode("ascii"), np.uint8)
    return CHAR_TO_CODE[raw].reshape(len(kmers), k)


def fw_codes_of_kmer_strings(kmers: list[str], k: int) -> np.ndarray:
    """Vectorized kmer_to_code over N strings: 2-bit packed forward codes."""
    if not kmers:
        return np.empty(0, np.int64)
    codes = codes_matrix_of_kmer_strings(kmers, k).astype(np.uint64)
    shifts = (2 * (k - 1 - np.arange(k))).astype(np.uint64)
    return (codes << shifts[None, :]).sum(axis=1, dtype=np.uint64).view(np.int64)


def keys_of_kmer_strings(kmers: list[str], k: int, hasher: str | None
                         ) -> np.ndarray:
    """Vectorized hash_str over N equal-length k-mer strings (host, numpy).

    Exact regime: canonical 2-bit code min(fw, rc) (itmo:utils/KmerUtils.java
    getKmerKey:59-61); hashed regime: canonical poly/FNV-1a via hash_codes_np.
    One probe batch for a whole subgraph instead of per-k-mer Python — the
    FMT whole-metagenome coloring path depends on this
    (src/tools/FMTVisualiser.java:287-300 colors every graph k-mer)."""
    if not kmers:
        return np.empty(0, np.int64)
    codes = codes_matrix_of_kmer_strings(kmers, k)
    if hasher is not None:
        return hash_codes_np(codes, hasher)
    u = codes.astype(np.uint64)
    shifts = (2 * (k - 1 - np.arange(k))).astype(np.uint64)
    fw = (u << shifts[None, :]).sum(axis=1, dtype=np.uint64)
    rshifts = (2 * np.arange(k)).astype(np.uint64)
    rc = ((u ^ np.uint64(3)) << rshifts[None, :]).sum(axis=1, dtype=np.uint64)
    return np.minimum(fw.view(np.int64), rc.view(np.int64))


def poly_hash_str(s: str) -> int:
    """Reference polynomial hash of one k-mer string (src/utils/PolynomialHash.java:7-16)."""
    from ..dna import CHAR_TO_CODE
    fw = rc = 1
    n = len(s)
    for i in range(n):
        fw = (fw * 5 + int(CHAR_TO_CODE[ord(s[i])])) & MASK64
        rc = (rc * 5 + (3 ^ int(CHAR_TO_CODE[ord(s[n - 1 - i])]))) & MASK64
    return min(_signed(fw), _signed(rc))


def fnv1a_hash_str(s: str) -> int:
    """Reference FNV-1a hash of one k-mer string (src/utils/FNV1AHash.java:21-31)."""
    from ..dna import CHAR_TO_CODE
    fw = rc = FNV_OFFSET_BASIS
    n = len(s)
    for i in range(n):
        fw = ((fw ^ int(CHAR_TO_CODE[ord(s[i])])) * FNV_PRIME) & MASK64
        rc = ((rc ^ (3 ^ int(CHAR_TO_CODE[ord(s[n - 1 - i])]))) * FNV_PRIME) & MASK64
    return min(_signed(fw), _signed(rc))


def hash_str(s: str, hasher: str | None) -> int:
    """Canonical key of a k-mer string under the given regime (host)."""
    if hasher is None:
        from ..dna import kmer_to_code, canonical_code
        return _signed(canonical_code(kmer_to_code(s), len(s)))
    if hasher == "poly":
        return poly_hash_str(s)
    if hasher == "fnv1a":
        return fnv1a_hash_str(s)
    raise ValueError(hasher)


def pack_reads(fragments: list[np.ndarray], batch: int, length: int) -> np.ndarray:
    """Pad a list of code arrays into a (batch, length) int32 matrix (pad -1).

    Fragments longer than `length` must be pre-chunked with k-1 overlap by the
    caller (see io batching).
    """
    out = np.full((batch, length), -1, np.int32)
    for i, frag in enumerate(fragments):
        out[i, : len(frag)] = frag
    return out
