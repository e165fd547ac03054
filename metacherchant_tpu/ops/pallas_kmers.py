"""Pallas (Triton route) kernel: rolling canonical k-mer extraction on the GPU.

The XLA form (ops/kmers.exact_canonical_kmers) is a lax.scan over read
positions whose carry is one int64 per read: on the GPU that lowers to a
device loop of one tiny fused kernel per position. This kernel runs the whole
rolling loop inside one launch, one thread per (read, position segment),
with fw, rc and the valid-run length held in registers:

  fw  = ((fw << 2) | c) & mask(2k)             (itmo:dna/kmers/ShortKmer.java:68-71)
  rc  = (rc >> 2) | ((3 - c) << (2k - 2))
  run = run + 1 if c is a base else 0
  key = min(fw, rc) if run >= k else SENTINEL

Both fw and rc fit 62 bits, so the signed min is the canonical key.

Layout is position-major: codes arrive as (L, B) and keys leave as (L, B),
so every step is one coalesced load and one coalesced store across a block of
reads. Each read is cut into segments of `seg_len` positions; a segment
first replays the k-1 positions before it (warm-up, nothing stored), which
leaves fw, rc and run exactly as a full pass would. Segments multiply the
number of blocks, so a 4096-read batch still spreads over the card's SMs.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .kmers import SENTINEL, _i64

#: reads per block (one thread each); a power of two for Triton
BLOCK_READS = 128
#: stored positions per segment
SEG_LEN = 64


def _extract_kernel(codes_ref, keys_ref, *, k: int, L: int, block_reads: int,
                    seg_len: int):
    c0 = pl.program_id(0) * block_reads
    seg_start = pl.program_id(1) * seg_len
    mask = _i64((1 << (2 * k)) - 1)
    shift_hi = 2 * k - 2
    cols = pl.ds(c0, block_reads)

    def step(t, carry):
        fw, rc, run = carry
        j = seg_start - (k - 1) + t
        inside = (j >= 0) & (j < L)
        jc = jnp.clip(j, 0, L - 1)
        c = plgpu.load(codes_ref.at[jc, cols])
        c = jnp.where(inside, c, -1)
        base = c >= 0
        cc = jnp.where(base, c, 0).astype(jnp.int64)
        fw = ((fw << 2) | cc) & mask
        rc = (rc >> 2) | ((3 - cc) << shift_hi)
        run = jnp.where(base, run + 1, 0)
        key = jnp.where(run >= k, jnp.minimum(fw, rc), SENTINEL)
        keep = jnp.full((block_reads,), inside & (j >= seg_start))
        plgpu.store(keys_ref.at[jc, cols], key, mask=keep)
        return fw, rc, run

    zeros = jnp.zeros((block_reads,), jnp.int64)
    jax.lax.fori_loop(0, seg_len + k - 1, step,
                      (zeros, zeros, jnp.zeros((block_reads,), jnp.int32)))


@functools.partial(jax.jit, static_argnames=("k", "interpret", "block_reads",
                                             "seg_len"))
def exact_keys_position_major(codes: jax.Array, k: int,
                              interpret: bool = False,
                              block_reads: int = BLOCK_READS,
                              seg_len: int = SEG_LEN) -> jax.Array:
    """(B, L) int32 codes -> (L, B) int64 canonical keys, SENTINEL where the
    window ending at that position is not all bases (k <= 31).

    keys[j, b] equals exact_canonical_kmers(codes, k)[0][b, j]."""
    B, L = codes.shape
    pad = -B % block_reads
    codes_t = jnp.pad(codes, ((0, pad), (0, 0)), constant_values=-1).T
    Bp = B + pad
    kern = functools.partial(_extract_kernel, k=k, L=L,
                             block_reads=block_reads, seg_len=seg_len)
    keys = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((L, Bp), jnp.int64),
        grid=(Bp // block_reads, pl.cdiv(L, seg_len)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(block_reads // 32, 1)),
        interpret=interpret,
        name="exact_canonical_kmers",
    )(codes_t)
    return keys[:, :B]
