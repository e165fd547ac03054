"""metacherchant_tpu: a JAX genomic-environment engine.

A from-scratch JAX/XLA/Pallas implementation of the capabilities of
ctlab/metacherchant: canonical k-mer counting of metagenomic reads on the
device, coverage-thresholded de Bruijn subgraph (genomic environment)
extraction by BFS from target genes, unitig contraction, and GFA/TSV/FASTA
emission, plus the read-classification, differential multi-graph and FMT
tool families.
"""
import os

import jax

# 64-bit keys (Java long semantics) everywhere.
jax.config.update("jax_enable_x64", True)

#: persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset: a
#: fixed directory of the checkout (listed in .gitignore), so that every
#: process of this checkout finds what an earlier one compiled
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)

__version__ = "0.1.0"
