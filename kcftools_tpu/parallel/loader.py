"""Streaming KMC -> sharded device hash table loader.

The wheat-scale story (BASELINE.md: 15 Gbp / ~10^10 k-mers, a table of
120+ GB) cannot materialize the k-mer table on one host. This loader
streams the ``.kmc_suf`` records in bounded slabs, routes each key to
the shard owning the top bits of its first bucket hash (the shard-local
placement scheme of parallel/sharded.py), builds each shard's
two-choice table independently - on a worker thread that OVERLAPS the
next pass's streaming - and places it directly on its owning
device(s). Host STAGING is bounded by

    slab bytes + 2 x (shards staged per pass) x (keys-per-shard bytes)

(two passes' staging may be live at once because of the build overlap)
regardless of the total table size; the built tables are DEVICE
memory - HBM on real devices, host RAM on the virtual CPU mesh either
way. When the budget holds fewer shards than the mesh's table axis,
the loader makes several passes over the file, staging a subset of
shards per pass (keys outside the pass are discarded on the fly).

Multi-host: every process runs the same loader but stages ONLY the
shards owned by its addressable devices (``jax.process_index``); the
global table array is assembled with
``jax.make_array_from_single_device_arrays``, the multi-host-native
construction - no host ever sees another host's shards. Under
``jax.distributed`` each host therefore holds table_bytes/n_hosts at
peak, which is what makes the 15 Gbp ladder config loadable at all.

The reference's analog is the mmap low-memory mode
(Data/KMC.java:84-102,173-189): never materialize, pay per-query IO.
Here the table still materializes - but in aggregate device HBM across
the mesh, with bounded host staging.
"""

import numpy as np

from .. import jaxinit  # noqa: F401
import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..engine.hashtable import (
    BUCKET_SLOTS,
    build_fixed,
    suggest_buckets,
)
from ..io.kmc import KMCReader
from ..native import route_shard
from ..utils.logger import Logger

_CLASS = "ShardedTableLoader"


class ShardedTableLoader:
    """Stream a KMC database into a table-axis-sharded device array.

    Usage:
        loader = ShardedTableLoader(db_prefix, mesh,
                                    ram_budget_bytes=2 << 30)
        scorer = loader.load_scorer(min_count=1)
    """

    def __init__(self, db_prefix, mesh, ram_budget_bytes=None,
                 load_factor: float = 0.8, slab_records=None):
        self.db_prefix = db_prefix
        self.mesh = mesh
        self.load_factor = float(load_factor)
        self.ram_budget = ram_budget_bytes
        self.slab_records = slab_records
        self.reader = KMCReader(db_prefix, materialize=False)
        if self.reader.kmer_length > 32:
            Logger.error(
                _CLASS,
                "sharded device tables support k <= 32 "
                f"(DB has k={self.reader.kmer_length})",
            )

    # -- planning -------------------------------------------------------------

    def _plan(self, nb_total):
        t_axis = self.mesh.shape["table"]
        nb_local = nb_total // t_axis
        n = self.reader.total_kmers
        # HOST staging bytes per shard: the keys routed to it
        # (hi+lo+cnt u32 x3). The built table is DEVICE memory (HBM on
        # real devices; on the virtual CPU mesh it is host RAM either
        # way, with or without passes), so it no longer counts against
        # the host staging budget. Builds overlap the next pass's
        # streaming, so up to two passes' staging is live at once -
        # hence the half-budget divisor.
        per_shard = (n // t_axis + 1) * 12
        if self.ram_budget:
            shards_per_pass = max(
                1, int((self.ram_budget // 2) // max(per_shard, 1))
            )
            if self.slab_records is None:
                # the decode slab (raw record bytes + decoded key/count
                # arrays) must fit the budget too
                rec = self.reader.suffix_length // 4 + \
                    self.reader.counter_size
                self.slab_records = max(
                    1 << 16, int(self.ram_budget // (2 * (rec + 12)))
                )
        else:
            shards_per_pass = t_axis
        return t_axis, nb_local, shards_per_pass

    def _my_shards(self, t_axis):
        """Table-shard ids owned by THIS process, and the devices that
        must hold each (the table is replicated along 'data')."""
        pidx = jax.process_index()
        mine = {}
        devs = self.mesh.devices  # (data, table) ndarray of devices
        for ti in range(t_axis):
            holders = [
                d for d in devs[:, ti].tolist() if d.process_index == pidx
            ]
            if holders:
                mine[ti] = holders
        return mine

    # -- loading --------------------------------------------------------------

    def load(self, nb_total=None):
        """Returns (global device array (nb_total, 3*S), nb_total)."""
        n = self.reader.total_kmers
        t_axis = self.mesh.shape["table"]
        if nb_total is None:
            nb_total = max(
                suggest_buckets(n, self.load_factor), t_axis * 2
            )
        while True:
            out = self._load_once(nb_total)
            if out is not None:
                return out, nb_total
            nb_total *= 2
            Logger.warning(
                _CLASS, f"Shard overflow; growing to {nb_total} buckets"
            )

    def _load_once(self, nb_total):
        k = self.reader.kmer_length
        t_axis, nb_local, per_pass = self._plan(nb_total)
        mine = self._my_shards(t_axis)
        shard_ids = sorted(mine)
        n_passes = max(1, -(-len(shard_ids) // per_pass))
        Logger.info(
            _CLASS,
            f"Streaming {self.reader.total_kmers} k-mers into "
            f"{t_axis} shards x {nb_local} buckets "
            f"({len(shard_ids)} local shards, {n_passes} pass(es))",
        )
        tspec = NamedSharding(self.mesh, P("table", None))
        # recorded for telemetry / scale-harness assertions
        self.last_stats = {
            "n_passes": n_passes,
            "local_shards": len(shard_ids),
            "shards_per_pass": per_pass,
            "nb_local": nb_local,
        }
        shard_bufs = {}  # shard id -> list of per-device jax arrays
        import threading

        fail = []
        build_thread = None

        def _build(staged_now):
            """Build + place this pass's shards (runs on a worker
            thread, overlapping the NEXT pass's file streaming)."""
            for s, parts in staged_now.items():
                if fail:
                    return
                if parts:
                    shi = np.concatenate([p[0] for p in parts])
                    slo = np.concatenate([p[1] for p in parts])
                    scn = np.concatenate([p[2] for p in parts])
                else:
                    shi = slo = scn = np.empty(0, np.uint32)
                staged_now[s] = None  # free staging before the build
                part = build_fixed(shi, slo, scn, nb_local)
                del shi, slo, scn
                if part is None:
                    fail.append(s)  # overflow -> caller grows nb_total
                    return
                shard_bufs[s] = [
                    jax.device_put(part, d) for d in mine[s]
                ]

        for pi in range(n_passes):
            want = set(shard_ids[pi * per_pass : (pi + 1) * per_pass])
            s_lo, s_hi = min(want), max(want) + 1
            staged = {s: [] for s in want}
            for kmers, counts in self.reader.iter_slabs(self.slab_records):
                # native one-pass route-and-compact (hash + shard id +
                # selection fused; the per-shard numpy selection loop
                # this replaces dominated streamed ingest)
                hi, lo, cnt, sh = route_shard(
                    kmers, counts, k, nb_total, nb_local, s_lo, s_hi,
                    want_ids=len(want) > 1,
                )
                if len(want) == 1:
                    if hi.shape[0]:
                        staged[s_lo].append((hi, lo, cnt))
                    continue
                # non-contiguous want sets: keys of unwanted mid-range
                # shards pass the range filter but match no s below
                for s in want:
                    sel = np.flatnonzero(sh == s)
                    if sel.size:
                        staged[s].append((hi[sel], lo[sel], cnt[sel]))
            if build_thread is not None:
                build_thread.join()
            if fail:
                return None
            build_thread = threading.Thread(target=_build, args=(staged,))
            build_thread.start()
        if build_thread is not None:
            build_thread.join()
        if fail:
            return None
        # assemble the global array from per-device shards (multi-host
        # native: every process contributes only its local shards)
        arrays = []
        for buflist in shard_bufs.values():
            arrays.extend(buflist)
        S3 = arrays[0].shape[1] if arrays else 3 * BUCKET_SLOTS
        global_arr = jax.make_array_from_single_device_arrays(
            (nb_total, S3), tspec, arrays
        )
        return global_arr

    def load_scorer(self, min_count: int = 1):
        """Build a ShardedWindowScorer directly over the streamed table."""
        from .sharded import ShardedWindowScorer

        tbl, nb_total = self.load()
        return ShardedWindowScorer.from_device_table(
            tbl,
            nb_total,
            self.mesh,
            k=self.reader.kmer_length,
            both_strands=self.reader.both_strands,
            min_count=min_count,
        )
