"""Unitig contraction as parallel pointer jumping (single device dispatch).

Device replacement for the reference's repeated full-array merge sweeps
(src/algo/OneSequenceCalculator.java:434-451 doMerge, O(sweeps * n) with
pointer-chasing): the doubled-node graph over oriented k-mer codes is
contracted with searchsorted adjacency + log-round pointer jumping.

Semantics: the reference merges node n into its unique neighbor m when
|neighbors(n)| == 1, |neighbors(m)| == 1 and tags match; in successor-edge
terms (neighbors(n) = successors of n.rc) that contracts every edge u -> v
with outdeg(u) == 1, indeg(v) == 1, tag(u) == tag(v). The fixpoint is the
standard maximal-unitig decomposition with tag barriers, which this kernel
computes directly. Deliberate divergences from the order-faithful host sweep
(algo/contraction.py, kept as the bug-for-bug default at environment scale):

- self-loop (u -> u) and hairpin (u -> rc(u)) edges are NEVER contracted;
  the reference's sweep merges some of them order-dependently (it does not
  even check `other.deleted`, see do_merge NOTE) producing arbitrary results
- requires odd k (even-k palindromic k-mers would alias their rc node)

Outputs feed assemble_nodes(), which rebuilds the writer-facing Node pairs +
symmetric adjacency with the same (k-1)-overlap rule as build_node_graph.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..algo.contraction import Node


def _revcomp_dev(codes: jax.Array, k: int) -> jax.Array:
    from .bfs_device import _revcomp_dev as rc
    return rc(codes, k)


@functools.partial(jax.jit, static_argnames=("k",))
def contract_codes_device(codes: jax.Array, tags: jax.Array, k: int):
    """codes: (N,) canonical k-mer codes (any order); tags: (N,) int32 merge
    tags (gene flag / color id / graph-set id).

    Returns (U, utags, head, dist):
      U     (2N,) sorted oriented codes (the doubled-node universe)
      utags (2N,) tag per oriented node
      head  (2N,) int32 index into U of each node's chain head
      dist  (2N,) int32 distance from head along the chain
    """
    if k % 2 == 0:
        raise ValueError("device contraction requires odd k")
    rc = _revcomp_dev(codes, k)
    U = jnp.concatenate([codes, rc])
    utags = jnp.concatenate([tags, tags])
    order = jnp.argsort(U)
    U = U[order]
    utags = utags[order]
    M = U.shape[0]
    idx = jnp.arange(M, dtype=jnp.int32)

    mask = np.int64((1 << (2 * k)) - 1)
    shift_hi = np.int64(2 * k - 2)
    nucs = jnp.arange(4, dtype=jnp.int64)

    def member(q):
        pos = jnp.searchsorted(U, q).astype(jnp.int32)
        pos_c = jnp.minimum(pos, M - 1)
        hit = U[pos_c] == q
        return hit, pos_c

    # successor candidates: u[1:] + n
    right = ((U[:, None] << 2) & mask) | nucs[None, :]
    r_hit, r_pos = member(right)
    outdeg = r_hit.sum(axis=1)
    succ = jnp.where(r_hit, r_pos, 0).sum(axis=1).astype(jnp.int32)

    # predecessor candidates: n + u[:-1]
    left = (U[:, None] >> 2) | (nucs[None, :] << shift_hi)
    l_hit, _ = member(left)
    indeg = l_hit.sum(axis=1)

    rc_idx = member(_revcomp_dev(U, k))[1]

    chain = ((outdeg == 1) & (indeg[succ] == 1) & (utags == utags[succ])
             & (succ != idx) & (succ != rc_idx))

    # parent pointer toward the head: parent[v] = u for contracted u -> v
    # (conflict-free: indeg(v) == 1 makes the claiming u unique)
    targets = jnp.where(chain, succ, M)
    parent = idx.at[targets].set(idx, mode="drop")

    # Chain components are either root-terminated paths or pure cycles
    # (outdeg==1/indeg==1 on every chain edge forbids trees hanging off a
    # cycle). Phase 1: pointer doubling propagating (rooted?, min-ancestor);
    # phase 2: break each cycle at its min node and jump to the final heads.
    rounds = int(np.ceil(np.log2(max(int(M), 2)))) + 1

    def body1(_, s):
        h, rooted, mn = s
        return h[h], rooted | rooted[h], jnp.minimum(mn, mn[h])

    _, rooted, mn = jax.lax.fori_loop(
        0, rounds, body1, (parent, parent == idx, jnp.minimum(idx, parent)))
    leader = (~rooted) & (idx == mn)
    parent = jnp.where(leader, idx, parent)

    def body2(_, s):
        h, d = s
        return h[h], d + d[h]

    head, dist = jax.lax.fori_loop(
        0, rounds, body2, (parent, (parent != idx).astype(jnp.int32)))
    return U, utags, head, dist


def contract_device(kmers: list[str], k: int, tag_of=None,
                    decorate=None) -> list[Node]:
    """Host wrapper: canonical k-mer strings -> contracted writer-facing Node
    list. tag_of(seq, rc) -> hashable merge tag (default: False);
    decorate(node, tag) applies tag attributes to a node (default: bool tag
    -> is_gene + GREEN color, like build_node_graph's default)."""
    from ..dna import reverse_complement
    from .kmers import fw_codes_of_kmer_strings
    if not kmers:
        return []
    codes = fw_codes_of_kmer_strings(kmers, k)
    tag_values = []
    tag_ids: dict = {}
    for s in kmers:
        t = tag_of(s, reverse_complement(s)) if tag_of else False
        if t not in tag_ids:
            tag_ids[t] = len(tag_ids)
        tag_values.append(tag_ids[t])
    tags = np.asarray(tag_values, np.int32)
    U, utags, head, dist = contract_codes_device(
        jnp.asarray(codes), jnp.asarray(tags), k)
    U, utags = np.asarray(U), np.asarray(utags)
    head, dist = np.asarray(head), np.asarray(dist)

    unitigs = assemble_unitigs(U, head, dist, k)
    id_of_tag = {v: t for t, v in tag_ids.items()}
    return assemble_nodes(
        [(seq, id_of_tag[int(utags[h])]) for seq, h in unitigs], k,
        decorate=decorate)


def assemble_unitigs(U: np.ndarray, head: np.ndarray, dist: np.ndarray,
                     k: int) -> list[tuple[str, int]]:
    """(unitig string, head index) per chain, one orientation per rc-pair."""
    from ..dna import code_to_kmer, NUCLEOTIDES, normalize
    order = np.lexsort((dist, head))
    h_sorted = head[order]
    starts = np.flatnonzero(np.concatenate(
        [[True], h_sorted[1:] != h_sorted[:-1]]))
    ends = np.append(starts[1:], h_sorted.size)
    last_char = np.frombuffer(NUCLEOTIDES.encode(), np.uint8)[U & 3]
    out: list[tuple[str, int]] = []
    seen: set[str] = set()
    for s, e in zip(starts, ends):
        grp = order[s:e]
        h = int(h_sorted[s])
        seq = code_to_kmer(int(U[h]), k)
        if e - s > 1:
            seq = seq + last_char[grp[1:]].tobytes().decode("ascii")
        # each chain appears on both strands; the mirror of a LINEAR chain is
        # the exact reverse complement, while the mirror of a linearized
        # CYCLE breaks at a different rotation -- dedup rotation-invariantly
        if len(seq) > k and seq[: k - 1] == seq[-(k - 1):]:
            core = seq[: -(k - 1)]
            norm = min(_min_rotation(core),
                       _min_rotation(reverse_complement_str(core)))
        else:
            norm = normalize(seq)
        if norm in seen:
            continue
        seen.add(norm)
        out.append((seq, h))
    return out


def _min_rotation(s: str) -> str:
    return min(s[i:] + s[:i] for i in range(len(s)))


def reverse_complement_str(s: str) -> str:
    from ..dna import reverse_complement
    return reverse_complement(s)


def assemble_nodes(unitigs: list[tuple[str, object]], k: int,
                   decorate=None) -> list[Node]:
    """Node pairs + symmetric (k-1)-overlap adjacency over contracted seqs
    (generalizes build_node_graph's rule to length > k)."""
    from ..dna import reverse_complement
    nodes: list[Node] = []
    for seq, tag in unitigs:
        rc = reverse_complement(seq)
        a = Node(seq, len(nodes))
        b = Node(rc, len(nodes) + 1)
        a.rc, b.rc = b, a
        if decorate is not None:
            decorate(a, tag)
            decorate(b, tag)
        elif tag is True:
            a.is_gene = b.is_gene = True
            a.color = b.color = "GREEN"
        nodes.extend((a, b))
    by_prefix: dict[str, list[Node]] = {}
    for n in nodes:
        by_prefix.setdefault(n.seq[: k - 1], []).append(n)
    for n in nodes:
        hit = by_prefix.get(n.seq[-(k - 1):])
        if hit:
            n.rc.neighbors.extend(hit)
    return nodes
