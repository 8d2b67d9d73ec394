"""Independent, deliberately-naive re-implementation of the reference's
per-window semantics (state machine and score math), used as the oracle
the vectorized/device pipeline is tested against.

Semantics transcribed from the reference behavior description:
GetVariants.processWindow (:202-261), getDistance (:267-273),
Fasta.getKmersList (:90-127), Fasta.getEffectiveATGCCount (:140-167),
Data.computeScore (:95-107).
"""

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def revcomp(s: str) -> str:
    return "".join(_COMP[c] for c in reversed(s))


def canonical(s: str) -> str:
    rc = revcomp(s)
    return min(s, rc)


def window_kmers(seq: str, k: int):
    """Valid k-mers in order (N-runs reset extraction)."""
    seq = seq.upper()
    out = []
    for i in range(len(seq) - k + 1):
        sub = seq[i : i + k]
        if all(c in "ACGT" for c in sub):
            out.append(sub)
    return out


def effective_atgc_count(seq: str, k: int) -> int:
    seq = seq.upper()
    count = 0
    stretch = 0
    for c in seq:
        if c in "ACGT":
            stretch += 1
        else:
            if stretch >= k:
                count += stretch
            stretch = 0
    if stretch >= k:
        count += stretch
    return count


def get_distance(gap_size: int, k: int) -> int:
    d = gap_size - (k - 1)
    if d <= 0:
        d = abs(d + 1)
    return d


def process_window(seq: str, k: int, db: dict, min_count=1, both_strands=True):
    """db: dict mapping k-mer string -> count (canonical keys when
    both_strands)."""
    total = observed = variation = inner = left = right = 0
    count_sum = 0
    gap = 0
    is_tail = True
    for km in window_kmers(seq, k):
        total += 1
        key = canonical(km) if both_strands else km
        cnt = db.get(key, 0)
        if cnt >= min_count:
            count_sum += cnt
            observed += 1
            if gap > 0:
                variation += 1
                if is_tail:
                    left += gap
                else:
                    inner += get_distance(gap, k)
            is_tail = False
            gap = 0
        else:
            gap += 1
    if total > 0 and gap > 0:
        variation += 1
        right += gap
    return {
        "total": total,
        "observed": observed,
        "variations": variation,
        "inner": inner,
        "left": left,
        "right": right,
        "count_sum": count_sum,
        "eff_length": effective_atgc_count(seq, k),
    }


def compute_score(observed, total, eff, inner, tail, weights):
    wi, wt, wr = weights
    if observed == 0 or total == 0 or eff == 0:
        return 0.0
    return (
        (wr * (observed / total))
        + (wi * (1.0 - inner / eff))
        + (wt * (1.0 - tail / eff))
    ) * 100.0


def count_db(seqs, k, both_strands=True, min_count=1):
    """Naive canonical k-mer counter -> dict."""
    db = {}
    for seq in seqs:
        for km in window_kmers(seq, k):
            key = canonical(km) if both_strands else km
            db[key] = db.get(key, 0) + 1
    return {km: c for km, c in db.items() if c >= min_count}


def find_ibs_summary(windows_in_order, samples):
    """Naive findIBS --summary math (reference FindIBS.java:175-272).

    windows_in_order: [(chrom, start, end, {sample: (ib, score)})] in the
    OUTPUT KCF's window order (the reference iterates chromosomes in its
    HashMap order; taking the output order makes this oracle independent
    of that emulation). Returns one row dict per (block, sample), in the
    reference's emission order: all blocks of sample 1, then sample 2...

    Semantics: per sample, blocks keyed by IB value in first-seen order;
    below-cutoff (IB == -1) windows buffer and attach to the next
    window's block only if that block already exists - otherwise they
    are dropped; trailing buffered windows are dropped. Mean score and
    proportion accumulate in float32 like the Java code.
    """
    import numpy as np

    rows = []
    for sample in samples:
        blocks = {}  # ib -> list of (chrom, start, end, score)
        order = []
        # the reference restarts the NA buffer per chromosome
        by_chrom = {}
        chrom_order = []
        for chrom, start, end, per in windows_in_order:
            if chrom not in by_chrom:
                by_chrom[chrom] = []
                chrom_order.append(chrom)
            by_chrom[chrom].append((chrom, start, end) + per[sample])
        for chrom in chrom_order:
            na = []
            for cw in by_chrom[chrom]:
                chrom_, start, end, ib, score = cw
                if ib == -1:
                    na.append((chrom_, start, end, ib, score))
                    continue
                if ib in blocks:
                    blocks[ib].extend(na)
                    blocks[ib].append((chrom_, start, end, ib, score))
                else:
                    blocks[ib] = [(chrom_, start, end, ib, score)]
                    order.append(ib)
                na.clear()
        for ib in order:
            blk = blocks[ib]
            total = len(blk)
            ibs_n = sum(1 for w in blk if w[3] != -1)
            mean = np.float32(0.0)
            for w in blk:
                mean += np.float32(w[4])
            mean = np.float32(mean / np.float32(total))
            prop = np.float32(ibs_n) / np.float32(total)
            rows.append(
                {
                    "Block": ib,
                    "Sample": sample,
                    "Chromosome": blk[0][0],
                    "Start": blk[0][1],
                    "End": blk[-1][2],
                    "Length": blk[-1][2] - blk[0][1],
                    "TotalBlocks": total,
                    "IBSBlocks": ibs_n,
                    "IBSProportion": float(prop),
                    "MeanScore": float(mean),
                }
            )
    return rows
