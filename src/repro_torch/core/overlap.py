"""Overlapped collective-matmul primitives (compute/comm overlap).

The classic "collective matmul" decompositions: instead of a blocking
all-gather (or all-reduce) around a matmul, rotate shards around the ring
with point-to-point hops while the product consumes the shard already in
hand — the distributed-optimization trick the NetKernel architecture lets
the operator deploy *under* unmodified model code. The products are plain
``torch.matmul``; every rank of the axis calls these in step.
"""
from __future__ import annotations

import torch

from repro_torch.core.nsm import MeshAxes, ppermute


def all_gather_matmul(x: torch.Tensor, w_shard: torch.Tensor, axis: str,
                      n: int, *, axes: MeshAxes) -> torch.Tensor:
    """Compute ``x @ all_gather(w_shard, axis)`` with ring hops.

    x:        (..., K)      replicated over ``axis``
    w_shard:  (K/n, N)      row-shard of W held by this rank
    returns:  (..., N)      == x @ W, identical on every ring member

    At step t the rank multiplies the shard it currently holds (owner
    ``(idx + t) % n``) against the matching K-slice of x while the shard is
    forwarded to the next neighbour.
    """
    idx = axes.index(axis)
    perm = [(i, (i - 1) % n) for i in range(n)]   # shard flows upstream
    k_blk = w_shard.shape[0]
    out = x.new_zeros(tuple(x.shape[:-1]) + (w_shard.shape[1],))
    cur = w_shard
    for t in range(n):
        owner = (idx + t) % n
        out = out + torch.matmul(x[..., owner * k_blk:(owner + 1) * k_blk],
                                 cur)
        if t != n - 1:
            cur = ppermute(cur, axis, perm, axes)
    return out


def matmul_reduce_scatter(x: torch.Tensor, w_shard: torch.Tensor, axis: str,
                          n: int, *, axes: MeshAxes) -> torch.Tensor:
    """Compute ``reduce_scatter(x @ w_shard, axis)`` with ring hops.

    x:        (M, K_local)  K-shard of the activation (TP contraction)
    w_shard:  (K_local, N)  matching row-shard of W
    returns:  (M/n, N)      this rank's slice of sum_k x_k @ w_k

    The partial product is computed one M-chunk at a time; the accumulator
    ring-hops so each chunk visits every rank exactly once, arriving at its
    owner fully reduced.
    """
    idx = axes.index(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    m = x.shape[0]
    if m % n:
        raise ValueError("leading dim must divide the ring for "
                         "reduce-scatter")
    m_blk = m // n
    acc = x.new_zeros((m_blk, w_shard.shape[1]))
    for t in range(n):
        # chunk that, after the remaining (n-1-t) downstream hops, lands on
        # its owner: contribution from rank r-j is always chunk r (mod n)
        c = (idx - t - 1) % n
        acc = acc + torch.matmul(x[c * m_blk:(c + 1) * m_blk], w_shard)
        if t != n - 1:
            acc = ppermute(acc, axis, perm, axes)
    return acc
