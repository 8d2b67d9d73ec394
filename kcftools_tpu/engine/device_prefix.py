"""Device-resident positional window scorer.

Split of the getVariations hot loop (Plugins/GetVariants.java:202-261):
the host owns the per-sample sorted merge join (data-dependent, served
by the native tier) and the positional gather, while the device owns
everything scan-shaped: the whole per-window gap-run state machine
re-expressed as prefix scans plus O(1) boundary gathers.

How the work is cut:

  - samples accumulate into groups of up to ``batch`` (8) and the whole
    group is scored by ONE execution per slab (_score_runs /
    _score_batch vmap over sample rows)
  - the per-sample payload is the compact ABSENT-RUN stream (native
    kcf_bits_to_runs, ~0.15 MB at percent-level variation rates)
    rather than the 0.65 MB positional bitmap; uploads start the moment
    a sample is packed, and the bitmap remains the fallback for
    run-dense samples
  - the device reconstructs presence from runs with one scatter + one
    8-bit prefix scan and gathers only at the B window boundaries; the
    positional gather happens on host (kcf_pack_posbits / kcf_ordpack)
  - all device math is int32/uint32; the one genuinely 64-bit quantity
    (per-window exact count sums for MeanKmerCount) is folded on host
    by the same native pass that packs the bits

Whether each of these choices pays on a given device is an open
measurement, not a premise of the semantics.

Per-sample device math is bit-identical to the host engine
(tests/test_device_prefix.py): for each window [s, hi] over k-mer
start positions,

  pres       = presence bits (valid k-mer && exact count >= min_count)
  cs_obs     = cumsum(pres)                    -> observed
  prev_ord   = cummax of present valid-ordinal -> interior gap sizes
  dist       = gap-(k-1) with the abs(d+1) clamp
               (GetVariants.java:267-273)
  next_ge /  = reverse cummin / cummax of present positions
  last_le      -> left/right tail distances
  variations = interior closed gaps + left/right tails, or (total>0)
               for windows with zero observed k-mers

Chromosomes are concatenated into fixed-shape SLABS (window-aligned
segments, so no window straddles a slab and per-window stats are exact
by construction), letting one compiled program cover the whole genome
and arbitrarily large references stream through bounded device memory.
Static per-window values (total k-mers, effective length) never depend
on the sample and stay with the caller.
"""

import functools
import os

from .. import jaxinit  # noqa: F401  (x64 + compile cache, before jax use)
import numpy as np

_POS_BUCKET = 1 << 20  # slab position padding granularity
_WIN_BUCKET = 1 << 10  # slab window padding granularity
_SEG_ALIGN = 64  # segments start on bit-word boundaries


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def _pad_u8(arr, cap):
    """Zero-pad a u8 run array to ``cap`` entries ((0, 0) = no-op)."""
    if arr.shape[0] >= cap:
        return arr[:cap]
    out = np.zeros(cap, np.uint8)
    out[: arr.shape[0]] = arr
    return out


_SCAN_BLK = 512  # slab padding granule (keeps reshape-based scans legal)


def _cumsum(x):
    import jax.numpy as jnp

    return jnp.cumsum(x)


def _cummax(x):
    import jax

    return jax.lax.cummax(x)


def _cummin_rev(x):
    import jax

    return jax.lax.cummin(x, reverse=True)


def _scan_core(pr, cs_tot, w_start, w_hi, *, k: int):
    """One sample's window statistics from per-position presence.

    pr: (n,) bool presence over k-mer start positions; cs_tot:
    (n+1,) int32 static prefix counts of valid k-mers; w_start/w_hi:
    (win_pad,) int32 window first/last k-mer start positions
    (inclusive, slab coords). Returns (5, win_pad) int32 rows:
    observed, variations, inner, left, right - the gap-run state
    machine (Plugins/GetVariants.java:219-261, distance correction
    :267-273) re-expressed as prefix scans + O(1) boundary gathers.
    """
    import jax
    import jax.numpy as jnp

    n = pr.shape[0]
    vidx = cs_tot[1:] - 1  # valid ordinal at each position (where valid)
    pos = jax.lax.iota(jnp.int32, n)
    s = w_start
    hi = w_hi
    total = cs_tot[hi + 1] - cs_tot[s]
    zero32 = jnp.zeros((1,), jnp.int32)

    pres_ord = jnp.where(pr, vidx, jnp.int32(-1))
    shifted = jnp.concatenate(
        [jnp.full((1,), -1, jnp.int32), pres_ord[:-1]]
    )
    prev_ord = _cummax(shifted)
    next_ge = _cummin_rev(jnp.where(pr, pos, jnp.int32(n)))
    last_le = _cummax(jnp.where(pr, pos, jnp.int32(-1)))

    cs_obs = jnp.concatenate([zero32, _cumsum(pr.astype(jnp.int32))])
    gap = vidx - prev_ord - 1
    closed = pr & (prev_ord >= 0) & (gap > 0)
    d = gap - (k - 1)
    dist = jnp.where(d > 0, d, jnp.abs(d + 1))
    cs_var = jnp.concatenate(
        [zero32, _cumsum(closed.astype(jnp.int32))]
    )
    # uint32 modular prefix; per-window diffs are exact (< 2^31)
    cs_dist = jnp.concatenate(
        [zero32.astype(jnp.uint32),
         _cumsum(jnp.where(closed, dist, 0).astype(jnp.uint32))]
    )

    observed = cs_obs[hi + 1] - cs_obs[s]
    has = observed > 0
    fp = jnp.clip(next_ge[s], 0, n - 1)
    lp = jnp.clip(last_le[hi], 0, n - 1)
    left = jnp.where(has, cs_tot[fp] - cs_tot[s], 0)
    right = jnp.where(has, cs_tot[hi + 1] - cs_tot[lp + 1], total)
    inner = jnp.where(
        has, cs_dist[hi + 1] - cs_dist[fp + 1], jnp.uint32(0)
    ).astype(jnp.int32)
    var_int = jnp.where(has, cs_var[hi + 1] - cs_var[fp + 1], 0)
    variations = jnp.where(
        has,
        var_int + (left > 0) + (right > 0),
        (total > 0).astype(jnp.int32),
    )
    return jnp.stack([observed, variations, inner, left, right])


def _score_batch(mat, cs_tot, w_start, w_hi, *, k: int):
    """Score S samples over one slab in ONE device execution from
    positional presence BITMAPS. mat: (S, slab_pad/8) uint8 LSB-first
    bitmaps, stacked on host so the whole group ships as ONE
    device_put. Returns (5, S, win_pad) int32."""
    import jax
    import jax.numpy as jnp

    n = mat.shape[1] * 8
    shifts = jnp.arange(8, dtype=jnp.uint8)

    def one(b8):
        pr = ((b8[:, None] >> shifts) & jnp.uint8(1)).reshape(n) != 0
        return _scan_core(pr, cs_tot, w_start, w_hi, k=k)

    return jnp.moveaxis(jax.vmap(one)(mat), 0, 1)  # (5, S, win_pad)


def _score_runs(dl, cs_tot, w_start, w_hi, *, k: int):
    """Score S samples over one slab in ONE device execution from
    compact ABSENT-RUN payloads (native kcf_bits_to_runs encoding:
    delta u8 from the previous run's end with (255, 0) fillers, length
    u8 with (0, 255) continuations). dl: (S, 2, run_cap) uint8 - the
    group's payloads stacked on host and shipped as ONE device_put.
    Presence is
    reconstructed as one scatter + one 8-bit prefix scan - absent
    stretches are disjoint, so the running +1/-1 prefix stays in
    {0, 1} - then masked by the static valid bitmap derived from
    cs_tot (positions the encoding trims or skips are invalid, so the
    masked reconstruction is exact). Returns (5, S, win_pad) int32."""
    import jax
    import jax.numpy as jnp

    n = cs_tot.shape[0] - 1
    dm = dl[:, 0, :].astype(jnp.int32)  # (S, R)
    lm = dl[:, 1, :].astype(jnp.int32)
    S = dm.shape[0]
    ends = jnp.cumsum(dm + lm, axis=1)
    starts = ends - lm
    rows = jnp.arange(S)[:, None]
    delta = jnp.zeros((S, n), jnp.int8)
    delta = delta.at[rows, starts].add(jnp.int8(1), mode="drop")
    delta = delta.at[rows, ends].add(jnp.int8(-1), mode="drop")
    absent = jnp.cumsum(delta, axis=1) > 0
    valid = (cs_tot[1:] > cs_tot[:-1])[None, :]
    pr = ~absent & valid

    def one(p):
        return _scan_core(p, cs_tot, w_start, w_hi, k=k)

    return jnp.moveaxis(jax.vmap(one)(pr), 0, 1)  # (5, S, win_pad)


class _Layout:
    """Chromosomes -> window-aligned segments -> fixed-shape slabs."""

    def __init__(self, k, slab_pos):
        self.k = int(k)
        self.slab_pos = int(slab_pos)
        self._chroms = []  # (name, r_idx, w_start, w_hi)
        self.slabs = None

    def add_chrom(self, name, r_idx, starts, ends):
        w_start = np.ascontiguousarray(starts, np.int32)
        w_hi = (np.asarray(ends, np.int64) - self.k).astype(np.int32)
        self.add_chrom_kcoords(name, r_idx, w_start, w_hi)

    def add_chrom_kcoords(self, name, r_idx, w_start, w_hi):
        """Windows already in k-mer start coordinates (feature mode).
        Windows shorter than k (w_hi < w_start) clamp to the empty
        range [s, s-1]: zero totals, zero stats."""
        w_start = np.ascontiguousarray(w_start, np.int32)
        w_hi = np.maximum(
            np.ascontiguousarray(w_hi, np.int32), w_start - 1
        )
        self._chroms.append(
            (name, np.ascontiguousarray(r_idx, np.int32), w_start, w_hi)
        )

    def _segments(self):
        """Split each chromosome's window list into runs whose position
        span fits one slab. Window k-mer ranges never straddle a
        segment, so per-window stats are exact under any split."""
        segs = []
        for name, r_idx, w_start, w_hi in self._chroms:
            n_win = len(w_start)
            i = 0
            while i < n_win:
                base = int(w_start[i])
                j = i
                endp = int(w_hi[i])
                while j + 1 < n_win:
                    ne = max(endp, int(w_hi[j + 1]))
                    nb = min(base, int(w_start[j + 1]))
                    if ne - nb + 1 > self.slab_pos:
                        break
                    j += 1
                    endp = ne
                    base = nb
                endp = min(endp, r_idx.shape[0] - 1)
                if endp < base:
                    endp = base
                segs.append(
                    {
                        "chrom": name,
                        "r_idx": r_idx[base : endp + 1],
                        "w_start": w_start[i : j + 1] - base,
                        "w_hi": np.minimum(w_hi[i : j + 1], endp) - base,
                        "c_off": i,
                    }
                )
                i = j + 1
        return segs

    def finalize(self, n_parts: int = 1):
        if self.slabs is not None:
            return
        if n_parts > 1:
            # shard the genome across devices: aim for >= n_parts slabs
            # (window-aligned, so per-window stats stay exact)
            total = sum(c[1].shape[0] for c in self._chroms)
            self.slab_pos = max(
                _SEG_ALIGN, min(self.slab_pos, -(-total // n_parts))
            )
        segs = self._segments()
        # first-fit in order into slabs of <= slab_pos positions
        groups = []
        cur, cur_pos = [], 0
        for seg in segs:
            seg_len = _round_up(seg["r_idx"].shape[0], _SEG_ALIGN)
            if cur and cur_pos + seg_len > self.slab_pos:
                groups.append(cur)
                cur, cur_pos = [], 0
            cur.append(seg)
            cur_pos += seg_len
        if cur:
            groups.append(cur)

        if not groups:
            self.pos_pad = _SEG_ALIGN
            self.win_pad = 64
            self.slabs = []
            self.chrom_n_win = {
                name: len(ws) for name, _r, ws, _h in self._chroms
            }
            return
        # shared padded shapes so every slab reuses one compiled program;
        # big layouts bucket coarsely for compile reuse across runs,
        # small ones pad only to the bit-word grid
        maxp = max(
            sum(_round_up(s["r_idx"].shape[0], _SEG_ALIGN) for s in g)
            for g in groups
        )
        maxw = max(sum(len(s["w_start"]) for s in g) for g in groups)
        pos_pad = _round_up(
            maxp, _POS_BUCKET if maxp >= _POS_BUCKET else _SCAN_BLK
        )
        win_pad = _round_up(maxw, _WIN_BUCKET if maxw >= _WIN_BUCKET else 64)
        self.pos_pad = pos_pad
        self.win_pad = win_pad

        self.slabs = []
        for g in groups:
            r_idx = np.full(pos_pad, -1, np.int32)
            w_start = np.zeros(win_pad, np.int32)
            w_hi = np.zeros(win_pad, np.int32)
            wins = []  # (chrom, chrom_win_off, slab_win_off, count)
            p_off = 0
            w_off = 0
            for seg in g:
                sl = seg["r_idx"].shape[0]
                nw = len(seg["w_start"])
                r_idx[p_off : p_off + sl] = seg["r_idx"]
                w_start[w_off : w_off + nw] = seg["w_start"] + p_off
                w_hi[w_off : w_off + nw] = seg["w_hi"] + p_off
                wins.append((seg["chrom"], seg["c_off"], w_off, nw))
                p_off += _round_up(sl, _SEG_ALIGN)
                w_off += nw
            cs_tot = np.zeros(pos_pad + 1, np.int32)
            np.cumsum(r_idx >= 0, out=cs_tot[1:])
            self.slabs.append(
                {
                    "r_idx": r_idx,
                    "cs_tot": cs_tot,
                    "w_start": w_start,
                    "w_hi": w_hi,
                    "n_win": w_off,
                    "wins": wins,
                }
            )
        self.chrom_n_win = {
            name: len(ws) for name, _r, ws, _h in self._chroms
        }


_FIELDS = ("observed", "variations", "inner", "left", "right")


class DevicePrefixScorer:
    """Per-reference device state + batched per-sample scoring.

    Single-sample flow (plugin compatibility):
        add_chrom(...) per chromosome, then per sample
        merge_and_upload(...) / set_sample_counts(...) followed by
        score_chrom(name) per chromosome.

    Batched flow (S samples per device dispatch):
        submit_counts(key, u8, exc_idx, exc_val) per sample, then
        collect(key) -> {chrom: {field: int64 array}}.

    Samples accumulate into a pending group; when ``batch`` samples are
    queued (or the first collect arrives) the group is stacked into one
    (S, n_bits) matrix per slab and scored by a SINGLE device execution
    (groups are padded to the fixed ``batch`` so exactly one program is
    ever compiled per slab shape).
    """

    def __init__(self, refidx, k, min_count=1, device=None, batch=None,
                 devices=None):
        import jax

        self.k = int(k)
        self.min_count = int(min_count)
        if devices is None:
            devices = [device] if device is not None else jax.devices()
        self.devices = list(devices)
        self.device = self.devices[0]
        if batch is None:
            batch = int(os.environ.get("KCFTOOLS_DEVICE_BATCH", "8"))
        # groups pad to exactly ``batch`` rows (one compiled program);
        # raise it when runs routinely carry more samples than that
        self.batch = max(1, int(batch))
        self.uplink = os.environ.get("KCFTOOLS_DPREFIX_UPLINK", "auto")
        slab = int(
            os.environ.get("KCFTOOLS_DPREFIX_SLAB", str(1 << 26))
        )
        self._layout = _Layout(self.k, slab)
        self._statics = None  # per-slab device arrays
        self._score_fns = {}
        self._cs_tot_fn = None  # device-side valid-prefix derivation
        self._pending = []  # queued sample slots awaiting dispatch
        self._jobs = {}  # sample key -> (group token, row in group)
        self._group_handles = {}  # group token -> per-slab result handles
        self._csums = {}  # sample key -> per-slab count sums
        self._results = {}  # key -> {chrom: {field: array}}
        self._merge_buf = None  # reused per-sample merge output
        self._run_cap = None  # sticky run-payload entry budget per slab
        env_cap = os.environ.get("KCFTOOLS_RUNS_CAP")
        self._cap_fixed = bool(env_cap)  # explicit cap: never grown
        if env_cap:
            self._run_cap = max(16, int(env_cap))
        self._seq = 0

    # -- reference-side setup ------------------------------------------------

    def add_chrom(self, name, r_idx, starts, ends):
        """Register one chromosome's static arrays.
        starts/ends: half-open window base ranges (end - start >= k)."""
        self._layout.add_chrom(name, r_idx, starts, ends)

    def add_chrom_kcoords(self, name, r_idx, w_start, w_hi):
        """Windows given directly in k-mer start coordinates (feature
        mode: one window per spliced gene/transcript)."""
        self._layout.add_chrom_kcoords(name, r_idx, w_start, w_hi)

    def _finalize(self):
        if self._statics is not None:
            return
        import jax

        from ..native import _uniform_window_map, build_ordmap

        self._layout.finalize(n_parts=len(self.devices))
        n_slabs = max(1, len(self._layout.slabs))
        # sample-axis spread: when there are more devices than slabs
        # (few-chromosome genomes on many devices), each slab gets a
        # POOL of devices and sample rows of a group split across the
        # pool - otherwise the extra devices idle while every slab's
        # whole group executes on its one device
        spread = max(1, len(self.devices) // n_slabs)
        self._spread = spread
        self._statics = []
        for si, slab in enumerate(self._layout.slabs):
            if spread > 1:
                pool = [
                    self.devices[(si * spread + j) % len(self.devices)]
                    for j in range(spread)
                ]
            else:
                pool = [self.devices[si % len(self.devices)]]
            dev = pool[0]
            nw = slab["n_win"]
            ws = slab["w_start"][:nw]
            wh = slab["w_hi"][:nw]
            # the ordinal pack's window mapping needs sorted,
            # non-overlapping windows (tiling mode and most feature
            # layouts)
            fusable = bool(
                nw < 2
                or ((ws[1:] > wh[:-1]).all() and (ws[1:] >= ws[:-1]).all())
            )
            valid_bits = np.packbits(slab["r_idx"] >= 0, bitorder="little")
            nbb = self._layout.pos_pad // 8
            if valid_bits.shape[0] < nbb:
                vb = np.zeros(nbb, np.uint8)
                vb[: valid_bits.shape[0]] = valid_bits
                valid_bits = vb
            # cs_tot (pos_pad+1 int32, the static valid-prefix counts)
            # is derived ON DEVICE from the packed valid bitmap - a
            # 32x smaller upload (per 2^26-position slab: 268 MB of
            # cs_tot vs 8.4 MB of bits)
            if self._cs_tot_fn is None:
                import jax.numpy as jnp

                def _cs_tot(vb):
                    n = vb.shape[0] * 8
                    shifts = jnp.arange(8, dtype=jnp.uint8)
                    bits = (
                        (vb[:, None] >> shifts) & jnp.uint8(1)
                    ).reshape(n)
                    return jnp.concatenate(
                        [jnp.zeros((1,), jnp.int32),
                         jnp.cumsum(bits.astype(jnp.int32))]
                    )

                self._cs_tot_fn = jax.jit(_cs_tot)
            st = {
                "device": dev,
                "pool": pool,
                # per-pool-device copies of the slab statics (one
                # device = the old layout; spreading replicates them)
                "cs_tot": [
                    self._cs_tot_fn(jax.device_put(valid_bits, d))
                    for d in pool
                ],
                "w_start": [
                    jax.device_put(slab["w_start"], d) for d in pool
                ],
                "w_hi": [jax.device_put(slab["w_hi"], d) for d in pool],
                # static valid bitmap for the run encoder (host)
                "valid_bits": valid_bits,
                "fusable": fusable,
                "ordmap": None,
                "uni": None,
            }
            if fusable:
                # one-time occurrence map: every sample's pack becomes
                # sequential streams instead of a random positional
                # gather (kcf_ordpack)
                st["ordmap"] = build_ordmap(slab["r_idx"])
                st["uni"] = _uniform_window_map(ws, wh)
            self._statics.append(st)

    def _score_fn(self, kind):
        import jax

        if kind not in self._score_fns:
            fn = _score_runs if kind == "runs" else _score_batch
            self._score_fns[kind] = jax.jit(
                functools.partial(fn, k=self.k)
            )
        return self._score_fns[kind]

    # -- per-sample ----------------------------------------------------------

    def merge_and_upload(self, ref_keys, db_keys, db_counts):
        """Native merge join + submit as the single pending sample.
        ref_keys/db_keys: uint64 arrays or (hi, lo) tuples (sorted)."""
        self.submit(None, ref_keys, db_keys, db_counts)

    def set_sample_counts(self, counts_u8, exc_idx, exc_val):
        self.submit_counts(None, counts_u8, exc_idx, exc_val)

    def submit(self, key, ref_keys, db_keys, db_counts):
        from ..native import merge_counts_u8

        n_ref = (
            ref_keys[0].shape[0]
            if isinstance(ref_keys, tuple)
            else ref_keys.shape[0]
        )
        if self._merge_buf is None or self._merge_buf.shape[0] < n_ref:
            self._merge_buf = np.empty(n_ref, np.uint8)
        u8, ei, ev = merge_counts_u8(
            ref_keys, db_keys, db_counts, out=self._merge_buf[:n_ref]
        )
        self.submit_counts(key, u8, ei, ev)

    def submit_counts(self, key, counts_u8, exc_idx, exc_val):
        """Pack one sample's payload on host and queue it in the
        pending group. Fusable slabs (sorted, non-overlapping windows)
        pack via the ordinal-space pass (kcf_ordpack: sequential
        streams + an L2-resident bit scatter - no random positional
        gather) into a presence bitmap + count-sum corrections, then
        run-encode the bitmap (kcf_bits_to_runs, ~25x fewer bytes to
        move than the bitmap at percent-level variation rates); other
        slabs fall back to pack_posbits. Once ``batch`` samples are
        queued (immediately for the single-sample flow) the group
        ships as ONE stacked device_put + ONE execution per slab.
        key=None marks the single-sample flow."""
        self._finalize()
        if key is None:
            # single-sample flow: a new sample invalidates the old one
            self._results.pop(None, None)
            self._discard_pending(None)
            old = self._jobs.pop(None, None)
            if old is not None and not any(
                t == old[0] for t, _r in self._jobs.values()
            ):
                # drop the stale group's handles only when no keyed
                # sample still references them (flows may be mixed)
                self._group_handles.pop(old[0], None)
            self._csums.pop(None, None)
        exc_idx = np.ascontiguousarray(exc_idx, np.int32)
        exc_val = np.ascontiguousarray(exc_val, np.uint32)
        slot = {"key": key, "bits": [], "runs": []}
        count_sums = []
        use_runs = self.uplink != "bitmap"
        self._pack_sample(
            slot, count_sums, counts_u8, exc_idx, exc_val, use_runs
        )
        self._pending.append(slot)
        self._csums[key] = count_sums
        if key is None or len(self._pending) >= self.batch:
            self._flush_pending()

    def _encode_with_cap(self, encode):
        """Run a run-encoder under the sticky per-slab entry budget:
        bootstrap it from the first sample (2x headroom,
        4096-granular), and GROW it when a later sample is denser (the
        in-flight group ships first at the old shape; one extra
        compile at the new shape) - unless KCFTOOLS_RUNS_CAP pinned it.
        ``encode(cap)`` returns (d, l, n); n < 0 = overflow. Returned
        arrays may exceed the final cap; the caller normalizes."""
        scratch = max(4096, self._layout.pos_pad // 16)
        if self._run_cap is None:
            d, l, n = encode(scratch)
            if n >= 0:
                cap = max(4096, -(-2 * max(n, 1) // 4096) * 4096)
                self._run_cap = min(cap, scratch)
            return d, l, n
        d, l, n = encode(self._run_cap)
        if n < 0 and not self._cap_fixed:
            d, l, n = encode(scratch)
            if n >= 0:
                self._flush_pending()  # old-shape group ships as-is
                cap = max(4096, -(-2 * n // 4096) * 4096)
                self._run_cap = min(cap, scratch)
        return d, l, n

    def _pack_sample(self, slot, count_sums, counts_u8, exc_idx, exc_val,
                     use_runs):
        """Encode one sample's payload + count-sum info for every
        slab. Fusable slabs: kcf_ordpack -> presence bitmap + count
        CORRECTIONS (count_sum = observed + corr; observed lands with
        the device result), then kcf_bits_to_runs under the sticky run
        budget - a budget overflow simply keeps that slab's bitmap
        payload (the bitmap already exists; no re-pack). Non-fusable
        slabs: pack_posbits with full count sums. Any bitmap slab
        drops the whole sample to the bitmap program (slot['runs'] =
        None); the group dispatcher then uses every slot's bitmaps."""
        from ..native import bits_to_runs, ordpack, pack_posbits

        all_runs = True
        for si, slab in enumerate(self._layout.slabs):
            st = self._statics[si]
            nw = slab["n_win"]
            ws = slab["w_start"][:nw]
            wh = slab["w_hi"][:nw]
            nbb = self._layout.pos_pad // 8
            if st["fusable"]:
                occ_ord, occ_pos, seg_off, seg_ord = st["ordmap"]
                bits, corr = ordpack(
                    counts_u8, exc_idx, exc_val, occ_ord, occ_pos,
                    self.min_count, ws, wh, st["valid_bits"], nbb,
                    uni=st["uni"], seg_off=seg_off, seg_ord=seg_ord,
                )
                count_sums.append(("corr", corr))
            else:
                bits, csum = pack_posbits(
                    counts_u8, exc_idx, exc_val, slab["r_idx"],
                    self.min_count, ws, wh, n_bits_bytes=nbb,
                )
                count_sums.append(("full", csum))
            slot["bits"].append(bits)
            if use_runs:

                def enc(cap, _bits=bits, _vb=st["valid_bits"]):
                    return bits_to_runs(_bits, _vb, self._layout.pos_pad,
                                        cap)

                d, l, n = self._encode_with_cap(enc)
                if n < 0:
                    all_runs = False
                else:
                    slot["runs"].append((d, l))
            else:
                all_runs = False
        if use_runs and all_runs:
            cap = self._run_cap
            slot["runs"] = [
                (_pad_u8(d, cap), _pad_u8(l, cap))
                for d, l in slot["runs"]
            ]
        else:
            slot["runs"] = None

    def _discard_pending(self, key):
        self._pending = [s for s in self._pending if s["key"] != key]

    def _flush_pending(self):
        """Dispatch the pending group as ONE stacked device_put + ONE
        (asynchronous) execution per slab. Groups are padded to the
        fixed ``batch`` row count with zero rows (a zero run stream /
        zero bitmap is a valid no-op payload), so every dispatch
        reuses one compiled program per slab shape. If every queued
        sample fits the run budget the compact run program is used;
        any bitmap sample drops the whole group to the bitmap program
        (the presence bitmaps always exist - no re-pack)."""
        group = self._pending
        self._pending = []
        if not group:
            return
        token = self._seq
        self._seq += 1
        kind = "runs" if all(s["runs"] is not None for s in group) else "bits"
        self._group_handles[token] = self._dispatch_group(group, kind)
        for row, slot in enumerate(group):
            self._jobs[slot["key"]] = (token, row)

    def _dispatch_group(self, group, kind):
        """Launch the batched scoring program for one group; transfer,
        execution and result fetch proceed asynchronously. Sample rows
        split across each slab's device POOL (sample-axis parallelism:
        with more chips than slabs, a group of S samples runs as
        pool-size chunks concurrently instead of serially on one
        chip). Returns per-slab lists of (handle, n_real_rows)."""
        import jax

        spread = getattr(self, "_spread", 1)
        chunk = -(-self.batch // spread)
        fn = self._score_fn(kind)
        handles = []
        for si in range(len(self._statics)):
            st = self._statics[si]
            if kind == "runs":
                cap = self._run_cap
                mat = np.zeros((self.batch, 2, cap), np.uint8)
                for r, slot in enumerate(group):
                    d, l = slot["runs"][si]
                    mat[r, 0, : min(d.shape[0], cap)] = d[:cap]
                    mat[r, 1, : min(l.shape[0], cap)] = l[:cap]
            else:
                nbb = self._layout.pos_pad // 8
                mat = np.zeros((self.batch, nbb), np.uint8)
                for r, slot in enumerate(group):
                    mat[r] = slot["bits"][si]
            slab_handles = []
            for j, dev in enumerate(st["pool"]):
                lo = j * chunk
                if lo >= self.batch:
                    break
                part = mat[lo : lo + chunk]
                if part.shape[0] < chunk:  # keep one compiled shape
                    part = np.concatenate(
                        [part,
                         np.zeros((chunk - part.shape[0],)
                                  + part.shape[1:], np.uint8)]
                    )
                h = fn(
                    jax.device_put(part, dev),
                    st["cs_tot"][j], st["w_start"][j], st["w_hi"][j],
                )
                # start the device->host copy as soon as the exec
                # finishes, so the fetch overlaps later submits/writes
                h.copy_to_host_async()
                slab_handles.append(h)
            handles.append(slab_handles)
        return handles

    def _take_group(self, token):
        """Fetch (once) and cache a dispatched group's result arrays,
        re-assembling row chunks from the slab's device pool."""
        arrs = self._group_handles[token]
        if arrs and not isinstance(arrs[0], np.ndarray):
            arrs = [
                np.concatenate(
                    [np.asarray(h) for h in slab_handles], axis=1
                )[:, : self.batch]
                for slab_handles in arrs
            ]
            self._group_handles[token] = arrs
        return arrs

    def collect(self, key=None):
        """Return {chrom: {field: (n_windows,) int64 array}} for a
        submitted sample, dispatching its group and awaiting the
        in-flight execution as needed."""
        if key in self._results:
            return self._results[key]
        if key not in self._jobs and any(
            s["key"] == key for s in self._pending
        ):
            self._flush_pending()
        if key not in self._jobs:
            raise KeyError(f"no submitted sample {key!r}")
        token, row = self._jobs.pop(key)
        group_arrs = self._take_group(token)
        if not any(t == token for t, _r in self._jobs.values()):
            # last sample of its group: release the cached group arrays
            # once sliced below
            self._group_handles.pop(token, None)
        csums = self._csums.pop(key)
        slabs = self._layout.slabs
        out = {
            name: {f: np.zeros(nw, np.int64) for f in _FIELDS}
            | {"count_sum": np.zeros(nw, np.int64)}
            for name, nw in self._layout.chrom_n_win.items()
        }
        for si, slab in enumerate(slabs):
            arr = group_arrs[si]  # (5, S, win_pad)
            csum_kind, csum = csums[si]
            for chrom, c_off, s_off, cnt in slab["wins"]:
                dst = out[chrom]
                for fi, f in enumerate(_FIELDS):
                    dst[f][c_off : c_off + cnt] = arr[
                        fi, row, s_off : s_off + cnt
                    ]
                cs = csum[s_off : s_off + cnt].astype(np.int64)
                if csum_kind == "corr":
                    # ordinal pack ships corrections only:
                    # count_sum = observed + sum(count - 1)
                    cs = cs + arr[0, row, s_off : s_off + cnt]
                dst["count_sum"][c_off : c_off + cnt] = cs
        self._results[key] = out
        return out

    def score_chrom(self, name):
        """Single-sample flow: stats for one chromosome."""
        return self.collect(None)[name]

    def devices_used(self):
        """Distinct devices holding slab state (for tests/telemetry)."""
        self._finalize()
        return {d for st in self._statics for d in st["pool"]}

    def sample_rows_devices(self):
        """Distinct devices that would execute a full group's sample
        rows (the sample-axis spread; for dryrun assertions)."""
        self._finalize()
        spread = getattr(self, "_spread", 1)
        chunk = -(-self.batch // spread)
        used = set()
        for st in self._statics:
            for j, dev in enumerate(st["pool"]):
                if j * chunk >= self.batch:
                    break
                used.add(dev)
        return used

    def discard(self, key=None):
        self._results.pop(key, None)

    def close(self):
        """Release queued state. Dispatch is inline/asynchronous, so
        there is no worker thread to join; uncollected result handles
        are simply dropped."""
        self._pending = []
        self._jobs.clear()
        self._group_handles.clear()
