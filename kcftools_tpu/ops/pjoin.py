"""Partitioned all-pairs k-mer join: the device lookup engine.

Resolves device-resident k-mer count lookups (the hot op of
GetVariants.getVariations - reference Data/KMC.java:292-326 resolves
each query with a signature scan + prefix-LUT + suffix binary search)
without per-query random table access:

* HOST (build, once per table): every key goes to partition
  ``h1(key) & (P-1)`` (the same 32-bit mix as engine/hashtable.py's
  first bucket hash, so placement stays a pure function of the key).
  Partitions are padded to a fixed tile of ``T_t`` slots -> three
  (P, T_t) uint32 arrays [hi | lo | count]; empty slots carry count 0,
  which no real KMC entry can (counts are >= 1).
* HOST (route, per query batch): queries are grouped by the same
  partition function into (P, T_q) tiles plus an int32 source-index
  map (-1 padding) - a native-radix counting sort at memory speed.
* DEVICE (one XLA program): for every partition,

      counts[q] = sum_t (q_hi==t_hi & q_lo==t_lo) * t_cnt

  as broadcast compares and a reduction over the table tile - fixed
  shapes, no gathers, no data-dependent control flow.

Exactness: a query matches a table slot only on the FULL (hi, lo) key,
every key is stored exactly once, and both sides use the same
partition function - so the result equals the hash-table/merge-join
count for every query, and scoring built on it stays byte-identical
(tests/test_pjoin.py checks against the two-choice table and a dict
oracle). k <= 32 (the device-engine envelope; wider k stays on the
host merge tier).
"""

from .. import jaxinit  # noqa: F401  (x64 + compile cache, before jax use)
import functools

import jax.numpy as jnp
import numpy as np

from ..engine.encode import split_hi_lo
from ..engine.hashtable import bucket_hashes_np
from ..utils.logger import Logger

_CLASS = "PJoin"

DEFAULT_TILE = 512
_LANE = 128


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def _next_pow2(x):
    n = 1
    while n < x:
        n <<= 1
    return n


def partition_of(hi, lo, P):
    """Partition id of each (hi, lo) key: the first bucket hash of the
    two-choice table masked to P (power of two) - one shared placement
    function for build and routing."""
    h1, _ = bucket_hashes_np(hi, lo, P)
    return h1


class PJoinTable:
    """Device-layout partitioned table: (P, T_t) uint32 hi / lo / cnt."""

    def __init__(self, th, tl, tc, k, n_keys, both_strands=True):
        self.th = th
        self.tl = tl
        self.tc = tc
        self.k = k
        self.n_keys = n_keys
        self.P = th.shape[0]
        self.tile = th.shape[1]
        self.both_strands = both_strands

    @property
    def nbytes(self):
        return self.th.nbytes + self.tl.nbytes + self.tc.nbytes


def build_pjoin_table(keys_u64, counts, k, tile=DEFAULT_TILE,
                      fill=0.65, both_strands=True):
    """Host-side build: partition + pad. Grows the tile if any
    partition overflows (rare at the default fill)."""
    keys_u64 = np.asarray(keys_u64, np.uint64)
    counts = np.ascontiguousarray(counts, np.uint32)
    n = keys_u64.shape[0]
    hi, lo = split_hi_lo(keys_u64, k)
    P = max(1, _next_pow2(int(np.ceil(n / (tile * fill)))))
    while True:
        part = partition_of(hi, lo, P)
        per = np.bincount(part, minlength=P)
        mx = int(per.max()) if n else 0
        if mx <= tile:
            break
        tile = _round_up(mx, _LANE)
    th = np.zeros((P, tile), np.uint32)
    tl = np.zeros((P, tile), np.uint32)
    tc = np.zeros((P, tile), np.uint32)
    if n:
        order = np.argsort(part, kind="stable")
        ps = part[order]
        rank = np.arange(n) - np.concatenate(
            ([0], np.cumsum(per))
        )[ps]
        th[ps, rank] = hi[order]
        tl[ps, rank] = lo[order]
        tc[ps, rank] = counts[order]
    tbl = PJoinTable(th, tl, tc, k, n, both_strands)
    Logger.info(
        _CLASS,
        f"Built pjoin table: {n} keys, {P} partitions x {tile} "
        f"({n / max(1, P * tile):.2f} fill, {tbl.nbytes / 1e6:.1f} MB)",
    )
    return tbl


def route_queries(kmers_u64, k, P, tile=None):
    """Group a query batch by partition: (q_hi, q_lo) (P, T_q) uint32
    tiles + src (P, T_q) int32 source indices (-1 = padding). The
    native radix pair sort does the grouping at memory speed."""
    from ..native import sort_pairs

    kmers_u64 = np.asarray(kmers_u64, np.uint64)
    n = kmers_u64.shape[0]
    hi, lo = split_hi_lo(kmers_u64, k)
    part = partition_of(hi, lo, P)
    per = np.bincount(part, minlength=P)
    mx = int(per.max()) if n else 0
    if tile is None:
        tile = max(_LANE, _next_pow2(mx))
    elif mx > tile:
        raise ValueError(f"query tile {tile} < max partition {mx}")
    comp = (part.astype(np.uint64) << np.uint64(32)) | np.arange(
        n, dtype=np.uint64
    )
    comp_s, _ = sort_pairs(comp, np.empty(n, np.uint32))
    order = (comp_s & np.uint64(0xFFFFFFFF)).astype(np.int64)
    ps = (comp_s >> np.uint64(32)).astype(np.int64)
    rank = np.arange(n) - np.concatenate(([0], np.cumsum(per)))[ps]
    qh = np.zeros((P, tile), np.uint32)
    ql = np.zeros((P, tile), np.uint32)
    src = np.full((P, tile), -1, np.int32)
    qh[ps, rank] = hi[order]
    ql[ps, rank] = lo[order]
    src[ps, rank] = order.astype(np.int32)
    return qh, ql, src


def _unpack_planar(w):
    """(B, Tt/4) planar-packed uint8 counts -> (B, Tt) uint32: byte b
    of word j holds the count of slot b*(Tt/4)+j, so unpacking is a
    concat of shifted planes."""
    return jnp.concatenate(
        [((w >> jnp.uint32(8 * b)) & jnp.uint32(0xFF)) for b in range(4)],
        axis=-1,
    )


@functools.lru_cache(maxsize=32)
def pjoin_lookup_fn(P, Tq, Tt, packed=False):
    """The jitted (P,Tq)x(P,Tt) -> (P,Tq) partition-join counts
    function. ``packed``: the count operand is (P, Tt/4) planar
    byte-packed uint32 words."""
    import jax

    def run(qh, ql, th, tl, tc):
        if packed:
            tc = _unpack_planar(tc)
        m = (qh[:, :, None] == th[:, None, :]) & (
            ql[:, :, None] == tl[:, None, :]
        )
        return jnp.sum(
            jnp.where(m, tc[:, None, :], jnp.uint32(0)),
            axis=2,
            dtype=jnp.uint32,
        )

    return jax.jit(run)


def quantile_partition_ids(keys_u64, b, k):
    """Monotone analytic equal-mass partition of CANONICAL k-mer values.

    Canonical keys are min(fwd, revcomp) of ~uniform values, so their
    value CDF is F(u) ~ 2u - u^2. Mapping each key's top 32 bits x
    through the integer-exact F'(x) = (x << 32) - (x*x >> 1) (monotone,
    range [0, 2^63]) and taking the top b bits yields 2^b partitions of
    near-equal occupancy (measured max/mean 1.1-1.3x) WITHOUT any
    hashing - and because F' is monotone, a SORTED key array has
    non-decreasing partition ids, so tiling both the table and the
    query side is pure slicing: no per-sample sort anywhere. The same
    function must be used for both sides of a join."""
    keys_u64 = np.asarray(keys_u64, np.uint64)
    x = (keys_u64 << np.uint64(64 - 2 * k) >> np.uint64(32)).astype(
        np.uint64
    )
    F = (x << np.uint64(32)) - ((x * x) >> np.uint64(1))
    return (F >> np.uint64(63 - b)).astype(np.int64)


def tile_sorted(keys_sorted, k, b, tile=None, counts=None):
    """Pad a SORTED canonical key array into (P, tile) uint32 quantile
    tiles (P = 2^b). Returns (hi_tiles, lo_tiles, cnt_tiles-or-None,
    rank) where rank[i] is key i's slot within its partition (so its
    flattened tile slot is part[i] * tile + rank[i]). Raises if any
    partition overflows ``tile`` (caller grows and retries)."""
    keys_sorted = np.asarray(keys_sorted, np.uint64)
    n = keys_sorted.shape[0]
    P = 1 << b
    part = quantile_partition_ids(keys_sorted, b, k)
    per = np.bincount(part, minlength=P)
    mx = int(per.max()) if n else 0
    if tile is None:
        tile = max(_LANE, _round_up(mx, _LANE))
    elif mx > tile:
        raise OverflowError(f"partition {int(per.argmax())} has {mx} > tile {tile}")
    starts = np.concatenate(([0], np.cumsum(per)))
    rank = np.arange(n) - starts[part]
    hi, lo = split_hi_lo(keys_sorted, k)
    th = np.zeros((P, tile), np.uint32)
    tl = np.zeros((P, tile), np.uint32)
    th[part, rank] = hi
    tl[part, rank] = lo
    tc = None
    if counts is not None:
        tc = np.zeros((P, tile), np.uint32)
        tc[part, rank] = counts
    return th, tl, tc, rank, part


def pjoin_lookup_np(table, kmers_u64):
    """Host-side end-to-end lookup through the device join: route,
    execute, unpartition. Returns uint32 counts aligned to the input
    order (absent keys -> 0)."""
    import jax

    kmers_u64 = np.asarray(kmers_u64, np.uint64)
    qh, ql, src = route_queries(kmers_u64, table.k, table.P)
    fn = pjoin_lookup_fn(table.P, qh.shape[1], table.tile)
    out = np.asarray(
        fn(
            jax.numpy.asarray(qh), jax.numpy.asarray(ql),
            jax.numpy.asarray(table.th), jax.numpy.asarray(table.tl),
            jax.numpy.asarray(table.tc),
        )
    )
    res = np.zeros(kmers_u64.shape[0], np.uint32)
    live = src >= 0
    res[src[live]] = out[live]
    return res
