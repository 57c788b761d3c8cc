"""Ragged-expansion primitives shared by grid builds and work schedulers.

The recurring pattern in this framework is expanding a ragged list (CSR
counts/offsets) into a dense, statically-sized work array: "position p of
the expansion belongs to segment f".  That is mathematically
``searchsorted(inclusive_scan, p, side='right')`` — but a binary search
is log2(F) *sequential gather passes* over every query.

Since the queries are always ``arange(capacity)`` (dense positions), the
same result is one scatter-add + one cumsum, both O(capacity):

    ids[p] = (# of segment starts <= p) - 1 = max{f : starts[f] <= p}

which equals ``clip(searchsorted(incl, p, 'right'), 0, F-1)`` for every
in-range position (p < total); out-of-range positions yield F-1 and are
masked by the caller's ``p < total`` validity test, exactly as the
clipped searchsorted result was.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_COARSE = 1024


def searchsorted_2level(sorted_arr, queries):
    """int32 side="left" searchsorted: coarse binary search over
    1024-stride row heads + one contiguous [Q, 1024] row gather and
    compare-count.

    jnp.searchsorted lowers to a serial while loop of ~log2(N) gather
    rounds; this halves the loop depth and turns the rest into dense
    elementwise work.
    The answer lies in row b-1 (row b's head is the first element >= q).
    """
    C = _COARSE
    n = sorted_arr.shape[0]
    pad = -n % C
    if pad:
        sorted_arr = jnp.pad(
            sorted_arr, (0, pad),
            constant_values=jnp.iinfo(sorted_arr.dtype).max)
    rows = sorted_arr.reshape(-1, C)
    b = jnp.searchsorted(rows[:, 0], queries, side="left")
    rb = jnp.clip(b - 1, 0, rows.shape[0] - 1)
    win = rows[rb]                                          # [Q, C]
    within = jnp.sum((win < queries[:, None]).astype(jnp.int32), axis=1)
    return jnp.minimum(rb * C + within, n)


def dense_int_bounds(sorted_keys, num_bins: int):
    """CSR bounds for DENSE integer queries over a sorted int array:
    returns [num_bins + 1] int32 with bounds[k] = first index whose key
    is >= k — identical to searchsorted_2level(sorted_keys,
    arange(num_bins + 1)) for keys in [0, num_bins).

    searchsorted_2level at these sizes pays a [Q, 1024] compare matrix
    plus a log-depth serial while; since every integer is queried,
    compact the RUN HEADS instead: sort
    (head ? key : num_bins, position) so the runs' (key, start) pairs
    bubble to the front ascending, scatter-min the first num_bins run
    starts into their key slots, and fill keyless bins with a reverse
    cummin (bounds[k] = start of the first run with key >= k).  One
    N-row 2-operand radix sort + one <=num_bins-row scatter.
    """
    n = sorted_keys.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    head = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_),
         sorted_keys[1:] != sorted_keys[:-1]])
    hk = jnp.where(head, sorted_keys, num_bins).astype(jnp.int32)
    sk, sp = jax.lax.sort((hk, pos), num_keys=1)
    m = min(num_bins, n)
    sk = sk[:m]
    sp = jnp.where(sk < num_bins, sp[:m], n)
    b = jnp.full((num_bins + 1,), n, jnp.int32)
    b = b.at[jnp.clip(sk, 0, num_bins)].min(sp, mode="drop")
    return jnp.flip(jax.lax.cummin(jnp.flip(b)))


def segment_ids_from_starts(starts, capacity: int):
    """Dense segment ids for positions arange(capacity).

    starts: [F] int32 ascending segment start offsets (an exclusive scan
    of segment lengths; zero-length segments repeat the next start).
    Returns [capacity] int32: for each position p, the segment owning it
    — max{f : starts[f] <= p}.  Positions past the last segment's end
    return F-1 (callers mask with their own validity predicate).
    """
    hist = jnp.zeros((capacity,), jnp.int32).at[starts].add(
        1, mode="drop")
    return jnp.cumsum(hist) - 1
