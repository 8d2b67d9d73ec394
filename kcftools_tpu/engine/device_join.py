"""Device-join window scorer: the merge join itself runs on the device.

The third device engine, completing the split begun by
engine/device_prefix.py. The dprefix engine keeps the per-sample
sorted merge join on the host (native tier) and ships compact presence
payloads; this engine ships the SAMPLE TABLE instead and performs the
join on device with the partitioned all-pairs join (ops/pjoin.py) in
place of the reference's hot lookup (Data/KMC.java:292-326 signature
scan + prefix LUT + binary search; GetVariants.java:202-261 consumes
the counts).

Flow:

  per REFERENCE (amortized, device-resident):
    - the sorted unique reference k-mers are quantile-tiled into
      static (P, Tq) query tiles (ops/pjoin.tile_sorted - monotone
      analytic partitioning, no sort), uploaded once;
    - per window-aligned slab (layout shared with the dprefix engine):
      a static int32 slot map position -> flattened routed slot, the
      packed valid bitmap (cs_tot derived on device), and the window
      bounds.
  per SAMPLE (the steady-state cost):
    - the ingested sorted (keys, counts) are quantile-SLICED into
      (P, Tt) table tiles - ~milliseconds of host work, no sort, and
      ONE stacked device_put (~9-12 bytes/key);
    - ONE join execution -> (P, Tq) counts aligned to the static
      reference routing;
    - per slab: positional gather through the static slot map,
      presence mask, the shared gap-run prefix scan
      (device_prefix._scan_core - bit-identical semantics), plus an
      exact count-sum prefix;
    - the fetch is per-window statistics only ((6, win_pad) int64 per
      slab), thousands of times smaller than the per-k-mer planes the
      host engines move.

Everything dispatches asynchronously; a multi-sample run pipelines
sample i+1's upload under sample i's execution and fetch.
"""

import functools
import os

from .. import jaxinit  # noqa: F401  (x64 + compile cache, before jax use)
import numpy as np

from ..ops.pjoin import _round_up
from ..utils.logger import Logger
from .device_prefix import _FIELDS, _Layout, _scan_core
from .encode import split_hi_lo

_CLASS = "DeviceJoin"

_JFIELDS = _FIELDS + ("count_sum",)


def _slab_scan(routed_flat, slot_map, valid_bits, w_start, w_hi, *,
               k: int, min_count: int, wide_windows: bool):
    """One slab's per-window stats from the routed join counts.
    Returns (6, win_pad) int64: observed, variations, inner, left,
    right, count_sum."""
    import jax.numpy as jnp

    n = slot_map.shape[0]
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = ((valid_bits[:, None] >> shifts) & jnp.uint8(1)).reshape(n)
    valid = bits != 0
    cs_tot = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(bits.astype(jnp.int32))]
    )
    cnts = routed_flat[slot_map]
    pr = (cnts >= jnp.uint32(min_count)) & valid
    five = _scan_core(pr, cs_tot, w_start, w_hi, k=k)
    kept = jnp.where(pr, cnts, jnp.uint32(0))
    zero32 = jnp.zeros((1,), jnp.uint32)
    if not wide_windows:
        # exact two-plane modular count sum: per-plane window sums are
        # < 2^32 whenever a window spans <= 65537 k-mer positions, so
        # the uint32 prefix diffs are exact without a float64 prefix
        cs_lo = jnp.concatenate(
            [zero32, jnp.cumsum(kept & jnp.uint32(0xFFFF))]
        )
        cs_hi = jnp.concatenate(
            [zero32, jnp.cumsum(kept >> jnp.uint32(16))]
        )
        lo = (cs_lo[w_hi + 1] - cs_lo[w_start]).astype(jnp.int64)
        hi = (cs_hi[w_hi + 1] - cs_hi[w_start]).astype(jnp.int64)
        count_sum = (hi << jnp.int64(16)) + lo
    else:
        csq = jnp.concatenate(
            [jnp.zeros((1,), jnp.float64),
             jnp.cumsum(kept.astype(jnp.float64))]
        )
        count_sum = (csq[w_hi + 1] - csq[w_start]).astype(jnp.int64)
    return jnp.concatenate(
        [five.astype(jnp.int64), count_sum[None, :]], axis=0
    )


def _score_sample(tiles, q_hi, q_lo, slot_maps, valid_bits, w_starts,
                  w_his, *, k: int, min_count: int, join_fn,
                  wide_windows: bool, P: int, Tt: int,
                  packed_counts: bool):
    """ONE device execution per sample: the partitioned join once,
    then every slab's gather + scan (mapped over the stacked slab
    statics). ``tiles`` is the flat uint32 upload: [hi (P*Tt) | lo
    (P*Tt) | counts], with counts either byte-packed 4-per-word (the
    common <=255 case - 9 bytes/key instead of 12) or full uint32.
    Returns (S, 6, win_pad) int64."""
    import jax
    import jax.numpy as jnp

    n = P * Tt
    th = tiles[:n].reshape(P, Tt)
    tl = tiles[n : 2 * n].reshape(P, Tt)
    if packed_counts:
        # planar byte-packed counts go into the join as-is; the join
        # unpacks them
        tc = tiles[2 * n :].reshape(P, Tt // 4)
    else:
        tc = tiles[2 * n :].reshape(P, Tt)
    routed = join_fn(q_hi, q_lo, th, tl, tc)
    flat = routed.reshape(-1)

    def one(args):
        sm, vb, ws, wh = args
        return _slab_scan(flat, sm, vb, ws, wh, k=k,
                          min_count=min_count, wide_windows=wide_windows)

    # lax.map, not vmap: slabs run sequentially inside the one launch,
    # so per-slab scan intermediates (several arrays of pos_pad words)
    # never coexist - at 325 Mbp+ genomes a vmapped scan would
    # materialize every slab's lanes at once and exhaust device HBM
    return jax.lax.map(one, (slot_maps, valid_bits, w_starts, w_his))


class DeviceJoinScorer:
    """DevicePrefixScorer-compatible interface; the merge runs on
    device. Requires the sample's sorted (keys, counts) - callers fall
    back to the dprefix engine when only streamed slabs are available.
    k <= 32."""

    def __init__(self, refidx, k, min_count=1, device=None, batch=None,
                 tile_target=512):
        import jax

        if k > 32:
            raise ValueError("device-join engine supports k <= 32")
        self.k = int(k)
        self.min_count = int(min_count)
        self.device = device or jax.devices()[0]
        if batch is None:
            batch = int(os.environ.get("KCFTOOLS_DEVICE_BATCH", "8"))
        self.batch = max(1, int(batch))
        # smaller slabs than the dprefix engine: the scan's prefix
        # lanes cost ~36 arrays of slab_pos int32 as XLA temporaries,
        # and lax.map bounds device memory to ONE slab's lanes - 2^24
        # positions keeps that ~2.4 GB
        slab = int(
            os.environ.get(
                "KCFTOOLS_DJOIN_SLAB",
                os.environ.get("KCFTOOLS_DPREFIX_SLAB", str(1 << 24)),
            )
        )
        self._layout = _Layout(self.k, slab)
        self._refk = refidx.kmers  # sorted unique uint64
        self._tile_target = int(tile_target)
        self._statics = None
        self._sample_tile = None  # sticky (P, Tt) shape across samples
        self._join_fn = None
        self._slab_fns = {}
        self._handles = {}  # key -> list of per-slab handles
        self._results = {}

    # -- reference-side setup -------------------------------------------

    def _pick_b(self, n_ref):
        """Partition bits so the MEAN occupancy lands in
        [tile_target, 2*tile_target): partition-count skew scales with
        1/sqrt(mean), so larger tiles pack tighter - at 325M keys this
        is fill 0.8 vs 0.6, i.e. ~35% less device memory and transfer
        for the query tiles, sample tiles and routed counts alike."""
        b = 1
        while (n_ref >> b) >= 2 * self._tile_target:
            b += 1
        return b

    def add_chrom(self, name, r_idx, starts, ends):
        self._layout.add_chrom(name, r_idx, starts, ends)

    def add_chrom_kcoords(self, name, r_idx, w_start, w_hi):
        self._layout.add_chrom_kcoords(name, r_idx, w_start, w_hi)

    def _finalize(self):
        if self._statics is not None:
            return
        import jax

        n_ref = self._refk.shape[0]
        b = self._pick_b(n_ref)
        from ..ops.pjoin import tile_sorted

        qh, ql, _tc, rank, part = tile_sorted(self._refk, self.k, b)
        self.P = 1 << b
        self.Tq = qh.shape[1]
        # flattened routed slot of each reference ordinal (static)
        slot_of_ord = (part * self.Tq + rank).astype(np.int64)
        self._q_hi = jax.device_put(qh, self.device)
        self._q_lo = jax.device_put(ql, self.device)
        Logger.info(
            _CLASS,
            f"Reference routed: {n_ref} k-mers -> {self.P} x {self.Tq} "
            f"query tiles ({n_ref / (self.P * self.Tq):.2f} fill)",
        )

        self._layout.finalize()
        slabs = self._layout.slabs
        S = len(slabs)
        nbb = self._layout.pos_pad // 8
        slot_maps = np.zeros((S, self._layout.pos_pad), np.int32)
        vbits = np.zeros((S, nbb), np.uint8)
        w_starts = np.zeros((S, self._layout.win_pad), np.int32)
        w_his = np.zeros((S, self._layout.win_pad), np.int32)
        for si, slab in enumerate(slabs):
            r_idx = slab["r_idx"]
            live = r_idx >= 0
            slot_maps[si, live] = slot_of_ord[r_idx[live]].astype(np.int32)
            packed = np.packbits(live, bitorder="little")
            vbits[si, : packed.shape[0]] = packed
            w_starts[si] = slab["w_start"]
            w_his[si] = slab["w_hi"]
        # the four static stacks ship as individual puts once per
        # reference; every per-sample dispatch reuses them in place
        self._statics = {
            "slot_maps": jax.device_put(slot_maps, self.device),
            "valid_bits": jax.device_put(vbits, self.device),
            "w_starts": jax.device_put(w_starts, self.device),
            "w_his": jax.device_put(w_his, self.device),
        }

    # -- per-sample ------------------------------------------------------

    def _get_sample_fn(self, Tt, packed):
        import jax

        from ..ops.pjoin import pjoin_lookup_fn

        fkey = (Tt, packed)
        if fkey not in self._slab_fns:
            join_fn = pjoin_lookup_fn(self.P, self.Tq, Tt, packed=packed)
            # windows spanning > 65537 k-mer positions need the float64
            # count-sum fallback; everything else takes the fast exact
            # two-plane uint32 path (static per layout)
            wide = any(
                int((s["w_hi"][: s["n_win"]] - s["w_start"][: s["n_win"]]).max()
                    if s["n_win"] else 0) + 1 > 65537
                for s in self._layout.slabs
            )
            self._slab_fns[fkey] = jax.jit(
                functools.partial(
                    _score_sample,
                    k=self.k,
                    min_count=self.min_count,
                    join_fn=join_fn,
                    wide_windows=wide,
                    P=self.P,
                    Tt=Tt,
                    packed_counts=packed,
                ),
            )
        return self._slab_fns[fkey]

    def _pack_tiles(self, db_keys, db_counts):
        """One flat uint32 upload buffer [hi | lo | counts] built by
        direct scatter (no intermediate stacks/pads). Counts <= 255
        byte-pack 4-per-word - 9 bytes/key to move instead of 12."""
        import ctypes

        from ..native import get_lib
        from ..ops.pjoin import quantile_partition_ids

        db_keys = np.ascontiguousarray(db_keys, np.uint64)
        n = db_keys.shape[0]
        b = self.P.bit_length() - 1
        lib = get_lib()
        if lib is not None:
            per = np.zeros(self.P, np.int64)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.kcf_pjoin_hist(
                db_keys.ctypes.data_as(u64p), ctypes.c_int64(n),
                ctypes.c_int(self.k), ctypes.c_int(b),
                per.ctypes.data_as(i64p),
            )
        else:
            part = quantile_partition_ids(db_keys, b, self.k)
            per = np.bincount(part, minlength=self.P).astype(np.int64)
        need = int(per.max()) if n else 1
        if self._sample_tile is None or need > self._sample_tile:
            # sticky tile with headroom so later samples of similar
            # size reuse the compiled program (growth = one recompile)
            self._sample_tile = _round_up(need + 64, 128)
        Tt = self._sample_tile
        packed = bool(db_counts.max(initial=0) <= 0xFF)
        nt = self.P * Tt
        words = nt // 4 if packed else nt
        buf = np.zeros(2 * nt + words, np.uint32)
        if lib is not None:
            lib.kcf_pjoin_pack(
                db_keys.ctypes.data_as(u64p),
                db_counts.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint32)
                ),
                ctypes.c_int64(n), ctypes.c_int(self.k),
                ctypes.c_int(b), ctypes.c_int64(Tt),
                ctypes.c_int(int(packed)),
                per.ctypes.data_as(i64p),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            )
        else:
            starts = np.concatenate(([0], np.cumsum(per)))
            rank = np.arange(n) - starts[part]
            hi, lo = split_hi_lo(db_keys, self.k)
            slot = part * Tt + rank
            buf[slot] = hi
            buf[nt + slot] = lo
            if packed:
                # planar layout: byte b of word (p, j) = count of slot
                # p*Tt + b*(Tt/4) + j (matches ops/pjoin._unpack_planar)
                cnt8 = np.zeros(nt, np.uint8)
                cnt8[slot] = db_counts
                c = cnt8.reshape(self.P, 4, Tt // 4).astype(np.uint32)
                buf[2 * nt :] = (
                    c[:, 0] | (c[:, 1] << np.uint32(8))
                    | (c[:, 2] << np.uint32(16))
                    | (c[:, 3] << np.uint32(24))
                ).ravel()
            else:
                buf[2 * nt + slot] = db_counts
        return buf, Tt, packed

    # above this many slab positions the join and the scan run as two
    # executions, so each phase's device-memory peak stands alone
    # instead of tiles + routed counts + scan lanes coexisting, at the
    # cost of one extra dispatch
    _FUSE_MAX_POS = 1 << 23

    def _get_split_fns(self, Tt, packed):
        import jax

        from ..ops.pjoin import pjoin_lookup_fn

        fkey = ("split", Tt, packed)
        if fkey not in self._slab_fns:
            join_fn = pjoin_lookup_fn(self.P, self.Tq, Tt, packed=packed)
            P, Tq = self.P, self.Tq

            def join_only(tiles, qh, ql):
                n = P * Tt
                th = tiles[:n].reshape(P, Tt)
                tl = tiles[n : 2 * n].reshape(P, Tt)
                tc = tiles[2 * n :].reshape(
                    P, Tt // 4 if packed else Tt
                )
                return join_fn(qh, ql, th, tl, tc)

            wide = any(
                int((s["w_hi"][: s["n_win"]] - s["w_start"][: s["n_win"]]).max()
                    if s["n_win"] else 0) + 1 > 65537
                for s in self._layout.slabs
            )
            k = self.k
            min_count = self.min_count

            def scan_all(routed, sms, vbs, wss, whs):
                flat = routed.reshape(-1)

                def one(args):
                    sm, vb, ws, wh = args
                    return _slab_scan(flat, sm, vb, ws, wh, k=k,
                                      min_count=min_count,
                                      wide_windows=wide)

                return jax.lax.map(one, (sms, vbs, wss, whs))

            # no donation: an unusable donation makes XLA COPY the
            # multi-GB operand (observed "donated buffers were not
            # usable"), doubling it in HBM; plain by-reference inputs
            # free by refcount right after their last use
            self._slab_fns[fkey] = (
                jax.jit(join_only),
                jax.jit(scan_all),
            )
        return self._slab_fns[fkey]

    def submit(self, key, ref_keys, db_keys, db_counts):
        """Ship one sample's sorted table and dispatch its join + slab
        scans (all asynchronous). ``ref_keys`` is accepted for
        interface compatibility with the dprefix engine."""
        import jax

        self._finalize()
        db_counts = np.ascontiguousarray(db_counts, np.uint32)
        buf, Tt, packed = self._pack_tiles(db_keys, db_counts)
        dev = jax.device_put(buf, self.device)  # ONE put per sample
        st = self._statics
        if self._layout.pos_pad > self._FUSE_MAX_POS:
            join_fn, scan_fn = self._get_split_fns(Tt, packed)
            routed = join_fn(dev, self._q_hi, self._q_lo)
            h = scan_fn(routed, st["slot_maps"], st["valid_bits"],
                        st["w_starts"], st["w_his"])
        else:
            h = self._get_sample_fn(Tt, packed)(
                dev, self._q_hi, self._q_lo, st["slot_maps"],
                st["valid_bits"], st["w_starts"], st["w_his"],
            )
        h.copy_to_host_async()
        self._handles[key] = h

    def submit_counts(self, key, counts_u8, exc_idx, exc_val):
        raise NotImplementedError(
            "device-join needs the sorted sample table; streamed-slab "
            "runs use the dprefix engine"
        )

    def collect(self, key=None):
        if key in self._results:
            return self._results[key]
        arr = np.asarray(self._handles.pop(key))  # (S, 6, win_pad)
        out = {
            name: {f: np.zeros(nw, np.int64) for f in _JFIELDS}
            for name, nw in self._layout.chrom_n_win.items()
        }
        for si, slab in enumerate(self._layout.slabs):
            for chrom, c_off, s_off, cnt in slab["wins"]:
                dst = out[chrom]
                for fi, f in enumerate(_JFIELDS):
                    dst[f][c_off : c_off + cnt] = arr[
                        si, fi, s_off : s_off + cnt
                    ]
        self._results[key] = out
        return out

    def score_chrom(self, name):
        return self.collect(None)[name]

    def discard(self, key=None):
        self._results.pop(key, None)

    def close(self):
        self._handles.clear()
        self._results.clear()


class MeshJoinScorer(DeviceJoinScorer):
    """Multi-device device-join: quantile partitions shard across the
    mesh's TABLE axis (each device holds 1/t of the reference query
    tiles and receives 1/t of every sample's table tiles - the
    wheat-scale layout where no device ever holds the whole table),
    genome slabs shard across the DATA axis. Per sample: local joins,
    ONE all_gather of the routed counts, then each data shard scans
    its slabs. Output and semantics identical to the
    single-device scorer."""

    def __init__(self, refidx, k, mesh, min_count=1, batch=None,
                 tile_target=512):
        super().__init__(refidx, k, min_count=min_count, batch=batch,
                         tile_target=tile_target)
        self.mesh = mesh
        self.t_axis = mesh.shape["table"]
        self.d_axis = mesh.shape["data"]

    def _finalize(self):
        if self._statics is not None:
            return
        import jax
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as PS

        from ..ops.pjoin import tile_sorted

        n_ref = self._refk.shape[0]
        b = self._pick_b(n_ref)
        while (1 << b) < self.t_axis:
            b += 1
        qh, ql, _tc, rank, part = tile_sorted(self._refk, self.k, b)
        self.P = 1 << b
        self.Tq = qh.shape[1]
        slot_of_ord = (part * self.Tq + rank).astype(np.int64)
        tspec = NamedSharding(self.mesh, PS("table", None))
        self._q_hi = jax.device_put(qh, tspec)
        self._q_lo = jax.device_put(ql, tspec)
        self._tspec = tspec
        Logger.info(
            _CLASS,
            f"Reference routed: {n_ref} k-mers -> {self.P} x {self.Tq} "
            f"query tiles across table={self.t_axis}",
        )

        self._layout.finalize(n_parts=self.d_axis)
        slabs = self._layout.slabs
        # pad the slab count to the data axis (dummy slabs are all-
        # invalid: zero valid bits -> zero stats)
        S = -(-max(len(slabs), 1) // self.d_axis) * self.d_axis
        nbb = self._layout.pos_pad // 8
        slot_maps = np.zeros((S, self._layout.pos_pad), np.int32)
        vbits = np.zeros((S, nbb), np.uint8)
        w_starts = np.zeros((S, self._layout.win_pad), np.int32)
        w_his = np.zeros((S, self._layout.win_pad), np.int32)
        for si, slab in enumerate(slabs):
            r_idx = slab["r_idx"]
            live = r_idx >= 0
            slot_maps[si, live] = slot_of_ord[r_idx[live]].astype(np.int32)
            packedb = np.packbits(live, bitorder="little")
            vbits[si, : packedb.shape[0]] = packedb
            w_starts[si] = slab["w_start"]
            w_his[si] = slab["w_hi"]
        dspec = NamedSharding(self.mesh, PS("data", None))
        self._statics = {
            "slot_maps": jax.device_put(slot_maps, dspec),
            "valid_bits": jax.device_put(vbits, dspec),
            "w_starts": jax.device_put(w_starts, dspec),
            "w_his": jax.device_put(w_his, dspec),
        }

    def _get_sample_fn(self, Tt, packed):
        import jax
        from jax.sharding import PartitionSpec as PS

        from ..ops.pjoin import pjoin_lookup_fn

        from jax import shard_map

        fkey = (Tt, packed)
        if fkey not in self._slab_fns:
            join_fn = pjoin_lookup_fn(
                self.P // self.t_axis, self.Tq, Tt, packed=packed
            )
            wide = any(
                int((s["w_hi"][: s["n_win"]] - s["w_start"][: s["n_win"]]).max()
                    if s["n_win"] else 0) + 1 > 65537
                for s in self._layout.slabs
            )
            k = self.k
            min_count = self.min_count

            def local(th, tl, tw, qh, ql, sms, vbs, wss, whs):
                routed_loc = join_fn(qh, ql, th, tl, tw)
                routed = jax.lax.all_gather(
                    routed_loc, "table", axis=0, tiled=True
                )
                flat = routed.reshape(-1)

                def one(args):
                    sm, vb, ws, wh = args
                    return _slab_scan(flat, sm, vb, ws, wh, k=k,
                                      min_count=min_count,
                                      wide_windows=wide)

                return jax.lax.map(one, (sms, vbs, wss, whs))

            mapped = shard_map(
                local,
                mesh=self.mesh,
                in_specs=(
                    PS("table", None), PS("table", None),
                    PS("table", None), PS("table", None),
                    PS("table", None),
                    PS("data", None), PS("data", None),
                    PS("data", None), PS("data", None),
                ),
                out_specs=PS("data", None, None),
                check_vma=False,
            )
            self._slab_fns[fkey] = jax.jit(mapped)
        return self._slab_fns[fkey]

    def submit(self, key, ref_keys, db_keys, db_counts):
        import jax

        self._finalize()
        db_counts = np.ascontiguousarray(db_counts, np.uint32)
        buf, Tt, packed = self._pack_tiles(db_keys, db_counts)
        nt = self.P * Tt
        th = jax.device_put(buf[:nt].reshape(self.P, Tt), self._tspec)
        tl = jax.device_put(
            buf[nt : 2 * nt].reshape(self.P, Tt), self._tspec
        )
        tw = jax.device_put(
            buf[2 * nt :].reshape(self.P, -1), self._tspec
        )
        st = self._statics
        h = self._get_sample_fn(Tt, packed)(
            th, tl, tw, self._q_hi, self._q_lo, st["slot_maps"],
            st["valid_bits"], st["w_starts"], st["w_his"],
        )
        h.copy_to_host_async()
        self._handles[key] = h


def sorted_keys_u64(db_sorted):
    """The (keys, counts) pair of an ingested sample in u64 form, or
    None when the ingest produced wide/streamed data."""
    keys, counts = db_sorted
    if isinstance(keys, tuple):
        return None
    return np.asarray(keys, np.uint64), counts
