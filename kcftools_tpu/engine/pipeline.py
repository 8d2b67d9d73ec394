"""The jitted end-to-end window scoring pipeline.

For a padded batch of windows this computes, entirely on device with
fixed shapes and no sequential host loops:

  2-bit codes -> rolling 16-base packs -> (hi,lo) canonical k-mers ->
  bucketed hash-table lookups -> per-window gap-run statistics.

The gap-run state machine of the reference (Plugins/GetVariants.java:
219-251) is replaced by a data-parallel formulation: with ``vidx`` the
ordinal of each valid k-mer and ``prev`` the ordinal of the previous
present k-mer (an exclusive running max), every gap statistic is an
elementwise expression + masked reduction:

  gap_before(i)   = vidx(i) - prev(i) - 1          (at present positions)
  leading gap     -> leftDist,  closed interior -> innerDistance with the
  reference's distance correction d<=0 -> |d+1| (GetVariants.java:267-273)
  trailing gap    -> rightDist (+1 variation)

Effective length (ACGT stretches >= k, Data/Fasta.java:140-167) uses the
same running-max trick on base-level validity runs.
"""

import functools

from .. import jaxinit  # noqa: F401  (x64 + compile cache, before jax use)
import jax
import jax.numpy as jnp
import numpy as np

from ..ops.kmerize import rolling_pack_u32, assemble_kmers, canonical_select
from ..ops.lookup import table_lookup

from .windows import PAD_MARGIN  # noqa: F401  (re-export; defined host-side)


def _exclusive_cummax(x, axis, init):
    shifted = jnp.concatenate(
        [jnp.full(x.shape[:axis] + (1,) + x.shape[axis + 1 :], init, x.dtype),
         jax.lax.slice_in_dim(x, 0, x.shape[axis] - 1, axis=axis)],
        axis=axis,
    )
    return jax.lax.cummax(shifted, axis=axis)


def score_windows_core(
    codes, valid, win_len, lookup_fn, *, k: int, min_count: int,
    both_strands: bool
):
    """codes: (B, Lp) uint32 2-bit codes (zero padded; Lp >= max window
    length + PAD_MARGIN). valid: (B, Lp) bool, ACGT-and-inside-window.
    win_len: (B,) int32 actual window lengths. lookup_fn maps (hi, lo)
    query arrays to uint32 counts (single-chip table or sharded).

    Returns dict of (B,) arrays: total, observed, variations, inner,
    left, right, count_sum (float64), eff_length.
    """
    B, Lp = codes.shape
    n_out = Lp - PAD_MARGIN  # k-mer start positions considered

    w32, rcw32 = rolling_pack_u32(codes)
    fwd_hi, fwd_lo, rc_hi, rc_lo = assemble_kmers(w32, rcw32, k, n_out)
    if both_strands:
        hi, lo = canonical_select(fwd_hi, fwd_lo, rc_hi, rc_lo)
    else:
        hi, lo = fwd_hi, fwd_lo

    counts = lookup_fn(hi, lo)

    present_raw = counts >= jnp.uint32(min_count)
    present_pad = jnp.concatenate(
        [present_raw, jnp.zeros((B, Lp - n_out), bool)], axis=1
    )
    res = gap_scan_core(valid, present_pad, win_len, k=k)

    # exact count sum over present-and-in-window k-mers (float64 < 2^53)
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, n_out), 1)
    vi = valid.astype(jnp.int32)
    cv = jnp.cumsum(vi, axis=1)
    cv_pad = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), cv], axis=1)
    run_k = cv_pad[:, k : k + n_out] - cv_pad[:, 0:n_out]
    kmer_valid = (run_k == k) & (pos <= win_len[:, None] - k)
    present = kmer_valid & present_raw
    res["count_sum"] = jnp.sum(
        jnp.where(present, counts, jnp.uint32(0)).astype(jnp.float64), axis=1
    )
    return res


FIELDS = (
    "total",
    "observed",
    "variations",
    "inner",
    "left",
    "right",
    "count_sum",
    "eff_length",
)

# sentinel code for non-ACGT / out-of-window positions in uint8 inputs
SENTINEL = np.uint8(4)


def _stack_results(res):
    """Pack the result dict into one (8, B) int64 array so a batch costs
    a single device->host readback. count_sum is summed in float64
    (exact below 2^53 - bounded by window_len * max_count ~ 2e14) and
    cast; everything else is int32-ranged. int64 specifically: some
    device transports degrade badly on float64 readbacks."""
    return jnp.stack([res[f].astype(jnp.int64) for f in FIELDS])


def _unstack(arr: np.ndarray):
    return {f: arr[i] for i, f in enumerate(FIELDS)}


def score_windows_device(
    codes, valid, win_len, tbl, *, k: int, min_count: int,
    both_strands: bool
):
    """Single-device scoring: core pipeline with a local table lookup."""
    return score_windows_core(
        codes,
        valid,
        win_len,
        lambda hi, lo: table_lookup(hi, lo, tbl),
        k=k,
        min_count=min_count,
        both_strands=both_strands,
    )


def _score_u8_batch(u8, win_len, tbl, *, k, min_count, both_strands):
    """u8: (B, Lp) uint8 codes with SENTINEL marking invalid positions."""
    valid = u8 < SENTINEL
    codes = jnp.where(valid, u8, jnp.uint8(0)).astype(jnp.uint32)
    res = score_windows_core(
        codes,
        valid,
        win_len,
        lambda hi, lo: table_lookup(hi, lo, tbl),
        k=k,
        min_count=min_count,
        both_strands=both_strands,
    )
    return _stack_results(res)


def _score_chunk(chunk_u8, starts, win_len, tbl, *, Lp, k,
                 min_count, both_strands):
    """chunk_u8: (C,) uint8 sentinel codes of a chromosome chunk; windows
    are gathered on device, so the host uploads each base once."""
    B = starts.shape[0]
    idx = starts[:, None] + jax.lax.broadcasted_iota(jnp.int32, (1, Lp), 1)
    idx = jnp.minimum(idx, chunk_u8.shape[0] - 1)
    u8 = chunk_u8[idx]
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, Lp), 1)
    u8 = jnp.where(pos < win_len[:, None], u8, SENTINEL)
    valid = u8 < SENTINEL
    codes = jnp.where(valid, u8, jnp.uint8(0)).astype(jnp.uint32)
    res = score_windows_core(
        codes,
        valid,
        win_len,
        lambda hi, lo: table_lookup(hi, lo, tbl),
        k=k,
        min_count=min_count,
        both_strands=both_strands,
    )
    return _stack_results(res)


def combine_u8(codes: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Host-side: merge (codes, valid) into sentinel-coded uint8."""
    return np.where(valid, codes.astype(np.uint8), SENTINEL)


# -- state-array scan path (hybrid engine) ----------------------------------
#
# When per-position counts are resolved on host (sorted-merge join against
# the reference k-mer index), the device input is one uint8 "state" per
# base: bit0 = base is ACGT, bit1 = the k-mer starting here is present
# (count >= min_count; only ever set where the k-mer is valid). The device
# runs only the inherently scan-shaped work: gap runs + effective length.
# total/observed/count_sum are exact host prefix-sum differences.

STATE_BASE_VALID = np.uint8(1)
STATE_PRESENT = np.uint8(2)


def gap_scan_core(valid, present, win_len, *, k: int):
    """The data-parallel gap-run scan, shared by both engines.

    valid: (B, Lp) base-level validity; present: (B, Lp) k-mer-start
    presence (already globally valid); win_len: (B,). Returns the scan
    fields only (variations, inner, left, right, eff_length) plus
    total/observed for convenience."""
    B, Lp = valid.shape
    n_out = Lp - PAD_MARGIN

    vi = valid.astype(jnp.int32)
    cv = jnp.cumsum(vi, axis=1)
    cv_pad = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), cv], axis=1)
    run_k = cv_pad[:, k : k + n_out] - cv_pad[:, 0:n_out]
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, n_out), 1)
    kmer_valid = (run_k == k) & (pos <= win_len[:, None] - k)
    present = present[:, :n_out] & kmer_valid

    kv = kmer_valid.astype(jnp.int32)
    vidx = jnp.cumsum(kv, axis=1) - 1
    pres_ord = jnp.where(present, vidx, jnp.int32(-1))
    prev = _exclusive_cummax(pres_ord, axis=1, init=jnp.int32(-1))

    gap_before = vidx - prev - 1
    closed = present & (gap_before > 0)
    leading = closed & (prev == -1)
    interior = closed & (prev >= 0)

    d = gap_before - (k - 1)
    dist = jnp.where(d > 0, d, jnp.abs(d + 1))

    left = jnp.sum(jnp.where(leading, gap_before, 0), axis=1)
    inner = jnp.sum(jnp.where(interior, dist, 0), axis=1)
    var_closed = jnp.sum(closed.astype(jnp.int32), axis=1)

    total = jnp.sum(kv, axis=1)
    observed = jnp.sum(present.astype(jnp.int32), axis=1)
    last_p = jnp.max(pres_ord, axis=1)
    trailing = total - 1 - last_p
    has_trailing = trailing > 0
    right = jnp.where(has_trailing, trailing, 0)
    variations = var_closed + has_trailing.astype(jnp.int32)

    bpos = jax.lax.broadcasted_iota(jnp.int32, (B, Lp), 1)
    prev_valid = jnp.concatenate([jnp.zeros((B, 1), bool), valid[:, :-1]], axis=1)
    next_valid = jnp.concatenate([valid[:, 1:], jnp.zeros((B, 1), bool)], axis=1)
    run_start = valid & ~prev_valid
    run_end = valid & ~next_valid
    start_pos = jax.lax.cummax(jnp.where(run_start, bpos, jnp.int32(-1)), axis=1)
    run_len = bpos - start_pos + 1
    eff = jnp.sum(jnp.where(run_end & (run_len >= k), run_len, 0), axis=1)

    return {
        "total": total,
        "observed": observed,
        "variations": variations,
        "inner": inner,
        "left": left,
        "right": right,
        "count_sum": jnp.zeros_like(total),
        "eff_length": eff,
    }


class WindowScorer:
    """Wraps a KmerTable on device + jitted scoring over padded batches.

    One uint8 upload and one packed readback per batch, with async
    dispatch so transfers and compute of consecutive batches overlap.
    """

    def __init__(self, table, min_count: int = 1, device=None):
        self.k = table.k
        self.min_count = int(min_count)
        self.both_strands = table.both_strands
        self.device = device
        put = (lambda x: jax.device_put(x, device)) if device else jax.device_put
        self.tbl = put(table.tbl)
        self._fns = {}
        self._chunk_fns = {}

    def set_table(self, table):
        """Swap in a new sample's table, keeping the compiled scoring
        programs (same table shape -> zero recompiles; a multi-sample
        device-engine run pays the jit cost once, not per sample).
        k/strandedness must match the construction-time table."""
        if table.k != self.k or table.both_strands != self.both_strands:
            raise ValueError("table k/strandedness changed; new scorer needed")
        put = (
            (lambda x: jax.device_put(x, self.device))
            if self.device
            else jax.device_put
        )
        self.tbl = put(table.tbl)

    def _fn(self, Lp: int):
        if Lp not in self._fns:
            self._fns[Lp] = jax.jit(
                functools.partial(
                    _score_u8_batch,
                    k=self.k,
                    min_count=self.min_count,
                    both_strands=self.both_strands,
                )
            )
        return self._fns[Lp]

    def _chunk_fn(self, Lp: int):
        if Lp not in self._chunk_fns:
            self._chunk_fns[Lp] = jax.jit(
                functools.partial(
                    _score_chunk,
                    Lp=Lp,
                    k=self.k,
                    min_count=self.min_count,
                    both_strands=self.both_strands,
                )
            )
        return self._chunk_fns[Lp]

    # -- padded-batch interface (variable-length windows) -------------------

    def score_batch_async(self, codes, valid, win_len):
        """Dispatch one padded batch; returns a device array handle."""
        u8 = combine_u8(np.asarray(codes), np.asarray(valid))
        return self._fn(u8.shape[1])(
            jnp.asarray(u8),
            jnp.asarray(win_len, jnp.int32),
            self.tbl,
        )

    def score_batch(self, codes, valid, win_len):
        return _unstack(np.asarray(self.score_batch_async(codes, valid, win_len)))

    # -- chunked interface (fixed windows over a chromosome chunk) ----------

    def score_chunk_async(self, chunk_u8, starts, win_len, Lp: int):
        """chunk_u8: (C,) sentinel codes (device or host); starts/win_len
        (B,). C, B, Lp must be stable across calls for compile reuse."""
        return self._chunk_fn(Lp)(
            chunk_u8 if isinstance(chunk_u8, jax.Array) else jnp.asarray(chunk_u8),
            jnp.asarray(starts, jnp.int32),
            jnp.asarray(win_len, jnp.int32),
            self.tbl,
        )

    @staticmethod
    def collect(handle) -> dict:
        """Resolve an async handle into a dict of host arrays."""
        return _unstack(np.asarray(handle))
