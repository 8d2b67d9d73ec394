"""Device-side canonical k-mer extraction over padded window batches.

K-mers are handled as (hi, lo) uint32 pairs: hi = first min(k,16)
bases big-endian, lo = the remaining k-16 bases, so all device
arithmetic stays 32-bit. Both halves of both strands fall out of two
16-base "rolling pack" arrays computed with 16 unrolled elementwise
shift-or passes - no sequential scan, no data-dependent shapes.

Let c[j] be the 2-bit code at position j (windows padded with zeros):

  w32[j]   = sum_t c[j+t] * 4^(15-t)      (big-endian 16-mer at j)
  rcw32[j] = sum_t (3-c[j+t]) * 4^t       (little-endian complement)

then for a k-mer starting at i with n_hi = min(k,16), n_lo = k-16:

  fwd_hi = w32[i]        >> 2*(16-n_hi)
  fwd_lo = w32[i+n_hi]   >> 2*(16-n_lo)
  rc_hi  = rcw32[i+k-n_hi] & (4^n_hi - 1)
  rc_lo  = rcw32[i]        & (4^n_lo - 1)

Canonical = lexicographic min, identical to the reference's big-endian
packed compare (Data/Kmer.java:72-79).
"""

from .. import jaxinit  # noqa: F401  (x64 + compile cache, before jax use)
import jax.numpy as jnp


def rolling_pack_u32(codes_padded):
    """codes_padded: (..., Lp) uint32 in 0..3 (padded with >=16 zeros at
    the end beyond any queried offset). Returns (w32, rcw32) of the same
    shape minus nothing - values at the last 15 positions are garbage and
    must be masked by the caller's validity logic."""
    L = codes_padded.shape[-1]
    n = L - 16
    w32 = jnp.zeros(codes_padded.shape[:-1] + (n,), jnp.uint32)
    rcw32 = jnp.zeros_like(w32)
    for t in range(16):
        c = codes_padded[..., t : t + n]
        w32 = w32 | (c << jnp.uint32(2 * (15 - t)))
        rcw32 = rcw32 | (((jnp.uint32(3) - c) & jnp.uint32(3)) << jnp.uint32(2 * t))
    return w32, rcw32


def assemble_kmers(w32, rcw32, k: int, n_out: int):
    """(fwd_hi, fwd_lo, rc_hi, rc_lo) for k-mer start positions
    0..n_out-1. w32/rcw32 must cover offsets up to n_out + k."""
    n_hi = min(k, 16)
    n_lo = k - n_hi
    fwd_hi = w32[..., 0:n_out]
    if n_hi < 16:
        fwd_hi = fwd_hi >> jnp.uint32(2 * (16 - n_hi))
    if n_lo > 0:
        fwd_lo = w32[..., n_hi : n_hi + n_out] >> jnp.uint32(2 * (16 - n_lo))
    else:
        fwd_lo = jnp.zeros_like(fwd_hi)
    rc_hi = rcw32[..., k - n_hi : k - n_hi + n_out] & jnp.uint32((1 << (2 * n_hi)) - 1)
    if n_lo > 0:
        rc_lo = rcw32[..., 0:n_out] & jnp.uint32((1 << (2 * n_lo)) - 1)
    else:
        rc_lo = jnp.zeros_like(rc_hi)
    return fwd_hi, fwd_lo, rc_hi, rc_lo


def canonical_select(fwd_hi, fwd_lo, rc_hi, rc_lo):
    use_rc = (rc_hi < fwd_hi) | ((rc_hi == fwd_hi) & (rc_lo < fwd_lo))
    hi = jnp.where(use_rc, rc_hi, fwd_hi)
    lo = jnp.where(use_rc, rc_lo, fwd_lo)
    return hi, lo
