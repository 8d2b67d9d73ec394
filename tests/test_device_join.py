"""Device-join engine (engine/device_join.py) vs the host oracle.

The third device engine must reproduce the per-window statistics of
the reference's gap-run state machine (Plugins/GetVariants.java:
202-261) exactly - here checked against tests/oracle.py through the
scorer interface, plus an end-to-end CLI byte-identity check against
the hybrid engine (the same gate every engine passes in
test_engines_agree.py). Runs on the CPU backend; the same XLA join
program runs on the GPU in chip_smoke.py.
"""

import numpy as np
import pytest

from kcftools_tpu.engine.device_join import DeviceJoinScorer
from kcftools_tpu.engine.encode import canonicalize, pack_kmers
from kcftools_tpu.engine.windows import tiling_windows

from .oracle import process_window


def _kmer_str(v, k):
    return "".join(
        "ACGT"[(int(v) >> (2 * (k - 1 - i))) & 3] for i in range(k)
    )


class _Ref:
    pass


@pytest.mark.parametrize("seed,length,counts_hi", [
    (1, 30_000, False),
    (2, 50_000, True),   # counts > 255 exercise the u32 tile fallback
])
def test_device_join_matches_oracle(seed, length, counts_hi):
    rng = np.random.default_rng(seed)
    k = 31
    window = 5000
    genome = rng.integers(0, 4, length).astype(np.uint8)
    # sprinkle non-ACGT resets
    nmask = rng.random(length) < 0.002
    valid = ~nmask
    kmers, kv = pack_kmers(genome, valid, k)
    canon = canonicalize(kmers, k)
    refk = np.unique(canon[kv])
    r_idx = np.full(canon.shape[0], -1, np.int32)
    r_idx[kv] = np.searchsorted(refk, canon[kv]).astype(np.int32)
    starts, ends = tiling_windows(length, window, k)

    # sample DB: mutated genome
    s = genome.copy()
    snp = rng.random(length) < 0.01
    s[snp] = (s[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    km2, kv2 = pack_kmers(s, valid, k)
    db, dbc = np.unique(canonicalize(km2[kv2], k), return_counts=True)
    dbc = dbc.astype(np.uint32)
    if counts_hi:
        dbc = dbc * np.uint32(300)  # push beyond the u8 plane

    ref = _Ref()
    ref.kmers = refk
    sc = DeviceJoinScorer(ref, k, min_count=1, batch=4)
    sc.add_chrom("c", r_idx, starts, ends)
    sc.submit(0, refk, db, dbc)
    res = sc.collect(0)["c"]

    seq = "".join("ACGTN"[c if v else 4] for c, v in zip(genome, valid))
    db_map = {
        _kmer_str(key, k): int(c) for key, c in zip(db.tolist(), dbc.tolist())
    }
    for w in range(len(starts)):
        exp = process_window(
            seq[starts[w]:ends[w]], k, db_map, min_count=1,
            both_strands=True,
        )
        for f in ("observed", "variations", "inner", "left", "right",
                  "count_sum"):
            assert res[f][w] == exp[f], (w, f, res[f][w], exp[f])


def test_device_join_multi_chrom_and_empty():
    rng = np.random.default_rng(7)
    k = 21
    ref = _Ref()
    chroms = {}
    all_canon = []
    for name, L in (("a", 9000), ("b", 4000)):
        g = rng.integers(0, 4, L).astype(np.uint8)
        km, kv = pack_kmers(g, np.ones(L, bool), k)
        cn = canonicalize(km, k)
        chroms[name] = (g, cn, kv)
        all_canon.append(cn[kv])
    refk = np.unique(np.concatenate(all_canon))
    ref.kmers = refk
    sc = DeviceJoinScorer(ref, k, min_count=1)
    geom = {}
    for name, (g, cn, kv) in chroms.items():
        r_idx = np.full(cn.shape[0], -1, np.int32)
        r_idx[kv] = np.searchsorted(refk, cn[kv]).astype(np.int32)
        starts, ends = tiling_windows(g.shape[0], 2000, k)
        sc.add_chrom(name, r_idx, starts, ends)
        geom[name] = len(starts)
    db = refk[::2]  # every other ref kmer present
    sc.submit("x", refk, db, np.ones(db.shape[0], np.uint32))
    out = sc.collect("x")
    for name, nw in geom.items():
        assert out[name]["observed"].shape[0] == nw
        assert out[name]["observed"].sum() > 0


@pytest.mark.parametrize("data,table", [(2, 4), (4, 2), (1, 8)])
def test_mesh_join_matches_single(data, table):
    """The mesh-sharded join (partitions across the table axis, slabs
    across the data axis, one all_gather) must equal the single-chip
    scorer exactly."""
    from kcftools_tpu.engine.device_join import MeshJoinScorer
    from kcftools_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(11)
    k = 31
    length = 60_000
    genome = rng.integers(0, 4, length).astype(np.uint8)
    valid = np.ones(length, bool)
    kmers, kv = pack_kmers(genome, valid, k)
    canon = canonicalize(kmers, k)
    refk = np.unique(canon[kv])
    r_idx = np.searchsorted(refk, canon).astype(np.int32)
    starts, ends = tiling_windows(length, 4000, k)

    s = genome.copy()
    snp = rng.random(length) < 0.01
    s[snp] = (s[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    km2, kv2 = pack_kmers(s, valid, k)
    db, dbc = np.unique(canonicalize(km2[kv2], k), return_counts=True)
    dbc = dbc.astype(np.uint32)

    ref = _Ref()
    ref.kmers = refk
    single = DeviceJoinScorer(ref, k, min_count=1)
    single.add_chrom("c", r_idx, starts, ends)
    single.submit(0, refk, db, dbc)
    want = single.collect(0)["c"]

    mesh = make_mesh(data=data, table=table)
    msc = MeshJoinScorer(ref, k, mesh, min_count=1)
    msc.add_chrom("c", r_idx, starts, ends)
    msc.submit(0, refk, db, dbc)
    got = msc.collect(0)["c"]
    for f in ("observed", "variations", "inner", "left", "right",
              "count_sum"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    # the table really is sharded: each device holds P/table partition
    # rows (replicated along data), and `table` distinct slices exist
    shards = msc._q_hi.addressable_shards
    assert shards[0].data.shape[0] == msc.P // table
    assert len({sh.index[0] for sh in shards}) == table
