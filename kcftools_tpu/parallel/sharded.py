"""Multi-device window scoring via shard_map over a (data, table) mesh.

Window batches are sharded along ``data`` (each chip scores its own
windows - the analog of the reference's thread pool). The k-mer table is
sharded along ``table``: every key's bucket lives on exactly one shard,
so each shard computes partial counts for the queries it can see
(buckets it owns; zeros elsewhere) and a ``psum`` over the table axis
yields exact global counts. Arrays sharded only along ``data`` are
replicated along ``table``, so no explicit query routing is needed -
the psum is the only collective.

On one device this degenerates to the plain WindowScorer; on N devices
with a replicated table it is pure data parallelism (no collectives at
all).
"""

import functools

from .. import jaxinit  # noqa: F401  (x64 + compile cache, before jax use)
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..engine.pipeline import _stack_results, _unstack, score_windows_core
from ..ops.lookup import bucket_hashes_jnp

from jax import shard_map


def _sharded_lookup(hi, lo, tbl, nb_total, axis="table"):
    """Lookup against the local bucket shard; caller psums over `axis`.

    tbl is the local shard (nb_local, 3*S) of the interleaved table,
    holding global buckets [shard*nb_local, (shard+1)*nb_local).

    Placement is SHARD-LOCAL: a key's owning shard is the top bits of
    its first bucket hash, and both candidate buckets live inside that
    shard (second choice = own-shard base | low bits of the second
    hash). This is exactly the single-device two-choice scheme when the
    table axis is 1, and it lets shards be built - and streamed from
    disk - independently, which is what makes bounded-RAM multi-host
    ingest possible (see parallel/loader.py)."""
    nb_local = tbl.shape[0]
    S = tbl.shape[1] // 3
    lm = jnp.uint32(nb_local - 1)
    my = jax.lax.axis_index(axis)
    base = my.astype(jnp.uint32) * jnp.uint32(nb_local)
    h1, h2 = bucket_hashes_jnp(hi, lo, nb_total)
    key_base = h1 & ~lm  # owning shard's first global bucket
    b1 = h1
    b2 = key_base | (h2 & lm)
    out = jnp.zeros(hi.shape, jnp.uint32)
    for b, dedup in ((b1, None), (b2, b2 != b1)):
        local = b - base
        owned = local < jnp.uint32(nb_local)  # uint wrap makes this a range test
        safe = jnp.where(owned, local, 0).astype(jnp.int32)
        rows = tbl[safe]
        match = (
            (rows[..., 0:S] == hi[..., None])
            & (rows[..., S : 2 * S] == lo[..., None])
            & (rows[..., 2 * S :] != 0)
            & owned[..., None]
        )
        contrib = jnp.sum(
            jnp.where(match, rows[..., 2 * S :], jnp.uint32(0)),
            axis=-1,
            dtype=jnp.uint32,
        )
        if dedup is not None:
            contrib = jnp.where(dedup, contrib, jnp.uint32(0))
        out = out + contrib
    return out


def make_sharded_scorer(mesh, *, k, min_count, both_strands, nb_total):
    """Build a jitted shard_map scoring function over `mesh`.

    Inputs: codes (B, Lp) uint32, valid (B, Lp) bool, win_len (B,) int32,
    sharded along 'data'; table arrays (nb_total, 8) sharded along
    'table'. B must be divisible by the data-axis size."""

    def local_fn(codes, valid, win_len, tbl):
        def lookup(hi, lo):
            partial = _sharded_lookup(hi, lo, tbl, nb_total)
            return jax.lax.psum(partial, "table")

        res = score_windows_core(
            codes,
            valid,
            win_len,
            lookup,
            k=k,
            min_count=min_count,
            both_strands=both_strands,
        )
        return _stack_results(res)

    mapped = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            P("data", None),
            P("data", None),
            P("data"),
            P("table", None),
        ),
        out_specs=P(None, "data"),
        check_vma=False,
    )
    return jax.jit(mapped)


def _reshard_table(table, t_axis):
    """Rebuild a host KmerTable with shard-local placement (idempotent:
    entries already placed shard-locally land in the same shards)."""
    from ..engine.hashtable import build_sharded_hilo

    live = table.counts != 0
    rows, cols = np.nonzero(live)
    return build_sharded_hilo(
        table.hi[rows, cols], table.lo[rows, cols],
        table.counts[rows, cols], table.k, t_axis,
        both_strands=table.both_strands,
    )


class ShardedWindowScorer:
    """Device-mesh version of engine.pipeline.WindowScorer."""

    def __init__(self, table, mesh, min_count: int = 1):
        self.k = table.k
        self.min_count = int(min_count)
        self.both_strands = table.both_strands
        self.mesh = mesh
        self.data_parallel = mesh.shape["data"]
        tspec = NamedSharding(mesh, P("table", None))
        t_axis = mesh.shape["table"]
        if t_axis > 1:
            # re-place entries shard-locally so every key's two candidate
            # buckets live on the shard owning its first hash (the
            # lookup scheme above); a table built by build_table_sharded
            # or the streaming loader already satisfies this
            table = _reshard_table(table, t_axis)
        nb = table.n_buckets
        # the bucket-ownership arithmetic needs the power-of-two bucket
        # count split evenly across the table axis
        if nb % t_axis:
            raise ValueError(f"table axis {t_axis} must divide bucket count {nb}")
        self.nb_total = nb
        self.tbl = jax.device_put(table.tbl, tspec)
        self._fns = {}
        self._dspec = NamedSharding(mesh, P("data", None))
        self._dspec1 = NamedSharding(mesh, P("data"))

    @classmethod
    def from_device_table(cls, tbl_device, nb_total, mesh, *, k,
                          both_strands, min_count: int = 1):
        """Wrap an already-sharded device table (streaming loader path:
        parallel/loader.py) without any host-side copy."""
        self = cls.__new__(cls)
        self.k = int(k)
        self.min_count = int(min_count)
        self.both_strands = bool(both_strands)
        self.mesh = mesh
        self.data_parallel = mesh.shape["data"]
        if nb_total % mesh.shape["table"]:
            raise ValueError("table axis must divide bucket count")
        self.nb_total = int(nb_total)
        self.tbl = tbl_device
        self._fns = {}
        self._dspec = NamedSharding(mesh, P("data", None))
        self._dspec1 = NamedSharding(mesh, P("data"))
        return self

    def _fn(self, Lp):
        if Lp not in self._fns:
            self._fns[Lp] = make_sharded_scorer(
                self.mesh,
                k=self.k,
                min_count=self.min_count,
                both_strands=self.both_strands,
                nb_total=self.nb_total,
            )
        return self._fns[Lp]

    def score_batch_async(self, codes, valid, win_len):
        """Dispatch one padded batch across the mesh; returns (handle, B)."""
        codes = np.asarray(codes)
        valid = np.asarray(valid)
        win_len = np.asarray(win_len)
        B = codes.shape[0]
        d = self.data_parallel
        padn = (-B) % d
        if padn:
            codes = np.vstack([codes, np.zeros((padn, codes.shape[1]), codes.dtype)])
            valid = np.vstack([valid, np.zeros((padn, valid.shape[1]), bool)])
            win_len = np.concatenate([win_len, np.zeros(padn, win_len.dtype)])
        handle = self._fn(codes.shape[1])(
            jax.device_put(jnp.asarray(codes, jnp.uint32), self._dspec),
            jax.device_put(jnp.asarray(valid, bool), self._dspec),
            jax.device_put(jnp.asarray(win_len, jnp.int32), self._dspec1),
            self.tbl,
        )
        return (handle, B)

    @staticmethod
    def collect(handle_b) -> dict:
        handle, B = handle_b
        res = _unstack(np.asarray(handle))
        return {key: v[:B] for key, v in res.items()}

    def score_batch(self, codes, valid, win_len):
        return self.collect(self.score_batch_async(codes, valid, win_len))
