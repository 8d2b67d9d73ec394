#!/usr/bin/env python
"""Smoke run of getVariations' device engines on the GPU.

Drives the main path through the CLI entry point
(``kcftools_tpu.cli.main``) on data generated from ``--seed``, checks
that every device engine writes KCFs byte-identical to the host engine's
(``##CMD``/``##DATE`` set aside), that the device scorers' arrays live
on the GPU, and that the device join matches a sorted-array dictionary
lookup exactly. Every output compared is an integer, so every check is
exact equality.

Default phases, one card:

  a  5 Mbp reference, k=31, 5 kb windows, 8 samples at 1% SNP:
     hybrid, dprefix and device (the on-device merge join), each run
     cold then warm
  b  the same reference in gene mode over a synthetic GTF of 1,200
     genes: device (the on-device hash pipeline) and dprefix
  c  one 40 Mbp contig, 50 kb windows, 2 samples at 0.5% SNP: device
     (several join slabs, split join and scan) and dprefix, with the
     peak device memory after each
  d  the device join at the phase-a shape against np.searchsorted

Options:

  --large  one 324,658,466 bp contig (lettuce chr3), 50 kb windows,
           1 sample: device and dprefix against hybrid. No other phase.
  --multi  every visible card (four on the target host): the phase-a
           data with --engine auto, which must resolve to dprefix with
           work on more than one card, and --engine device (the mesh
           hash scorer), both against hybrid. No other phase.

The card's name and power limit come first; the last line of standard
output is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Any failure exits non-zero before that line. Without a GPU the script
exits non-zero at once.

    python chip_smoke.py [--large | --multi] [--seed N] [--workdir DIR]
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

K = 31
_STRIP = (b"##CMD", b"##DATE")


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().replace("\n", "; ")


# -- data ---------------------------------------------------------------


def write_fasta(path, name, genome):
    """2-bit codes -> 60-column FASTA, written in one pass."""
    bases = np.frombuffer(b"ACGT", np.uint8)[genome]
    width = 60
    pad = (-bases.shape[0]) % width
    rows = np.concatenate([bases, np.zeros(pad, np.uint8)]).reshape(-1, width)
    out = np.full((rows.shape[0], width + 1), ord("\n"), np.uint8)
    out[:, :width] = rows
    buf = out.tobytes()
    if pad:
        buf = buf[: -(pad + 1)] + b"\n"
    with open(path, "wb") as fh:
        fh.write(f">{name}\n".encode())
        fh.write(buf)


def write_sample_db(prefix, genome, rng, snp):
    """Mutate ``genome`` at rate ``snp`` and write the sample's canonical
    k-mer counts as a KMC3 database. Returns the sorted keys and counts."""
    from kcftools_tpu.engine.encode import canonicalize, pack_kmers
    from kcftools_tpu.io.kmc import write_kmc_db
    from kcftools_tpu.native import sort_pairs

    sample = genome.copy()
    flip = rng.random(genome.shape[0]) < snp
    sample[flip] = (sample[flip] + rng.integers(1, 4, flip.sum())) % 4
    kmers, kv = pack_kmers(sample, np.ones(sample.shape[0], bool), K)
    del sample, flip
    canon = canonicalize(kmers[kv], K)
    del kmers, kv
    ks, _ = sort_pairs(canon, np.empty(canon.shape[0], np.uint32))
    del canon
    keep = np.empty(ks.shape[0], bool)
    keep[:1] = True
    keep[1:] = ks[1:] != ks[:-1]
    first = np.flatnonzero(keep)
    keys = ks[keep]
    counts = np.diff(np.append(first, ks.shape[0])).astype(np.uint32)
    del ks, keep, first
    write_kmc_db(prefix, keys, counts, K, counter_size=2)
    return keys, counts


def write_gtf(path, chrom, seq_len, rng, n_genes=1200):
    """Synthetic GTF: genes of 1-3 exons scattered over ``chrom``."""
    starts = np.sort(rng.choice(seq_len - 4000, n_genes, replace=False))
    with open(path, "w") as fh:
        for gi, g0 in enumerate(starts):
            gene = f"g{gi:05d}"
            tr = gene + ".1"
            pos = int(g0)
            exons = []
            for _ in range(int(rng.integers(1, 4))):
                ex_len = int(rng.integers(150, 900))
                exons.append((pos + 1, pos + ex_len))
                pos += ex_len + int(rng.integers(50, 400))
            g_end = exons[-1][1]
            fh.write(f'{chrom}\tsyn\tgene\t{g0 + 1}\t{g_end}\t.\t+\t.\t'
                     f'gene_id "{gene}";\n')
            fh.write(f'{chrom}\tsyn\ttranscript\t{g0 + 1}\t{g_end}\t.\t+\t.\t'
                     f'gene_id "{gene}"; transcript_id "{tr}";\n')
            for a, b in exons:
                fh.write(f'{chrom}\tsyn\texon\t{a}\t{b}\t.\t+\t.\t'
                         f'gene_id "{gene}"; transcript_id "{tr}";\n')


def build_dataset(work, tag, rng, *, length, n_samples, snp, contig="chr1"):
    """A random reference and ``n_samples`` mutated KMC3 databases under
    ``work/tag``."""
    d = os.path.join(work, tag)
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    genome = rng.integers(0, 4, length, dtype=np.uint8)
    ref = os.path.join(d, "ref.fa")
    write_fasta(ref, contig, genome)
    dbs, first = [], None
    for i in range(n_samples):
        p = os.path.join(d, f"s{i}")
        kc = write_sample_db(p, genome, rng, snp)
        first = first or kc
        dbs.append(p)
    print(f"{tag}: {length:,} bp reference, {n_samples} sample DB(s) "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    return {"dir": d, "genome": genome, "ref": ref, "contig": contig,
            "dbs": dbs, "first": first}


# -- runs ---------------------------------------------------------------


def run_cli(argv):
    """One CLI command in this process, its log diverted to stderr."""
    from kcftools_tpu.cli import main as cli_main

    with contextlib.redirect_stdout(sys.stderr):
        rc = cli_main(argv)
    if rc != 0:
        raise RuntimeError(f"kcftools {' '.join(argv)} exited {rc}")


def _device_arrays(obj):
    import jax

    if isinstance(obj, jax.Array):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _device_arrays(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _device_arrays(v)


@contextlib.contextmanager
def tracked_scorers():
    """Record every device scorer the CLI builds inside the block."""
    from kcftools_tpu.engine.device_join import DeviceJoinScorer
    from kcftools_tpu.engine.device_prefix import DevicePrefixScorer
    from kcftools_tpu.engine.pipeline import WindowScorer
    from kcftools_tpu.parallel.sharded import ShardedWindowScorer

    made = []
    saved = []

    def wrap_init(cls):
        orig = cls.__dict__["__init__"]

        def init(self, *a, **kw):
            orig(self, *a, **kw)
            made.append(self)

        saved.append((cls, "__init__", orig))
        cls.__init__ = init

    for cls in (DeviceJoinScorer, DevicePrefixScorer, WindowScorer,
                ShardedWindowScorer):
        wrap_init(cls)
    orig_fdt = ShardedWindowScorer.__dict__["from_device_table"]

    def from_device_table(cls, *a, **kw):
        s = orig_fdt.__func__(cls, *a, **kw)
        made.append(s)
        return s

    saved.append((ShardedWindowScorer, "from_device_table", orig_fdt))
    ShardedWindowScorer.from_device_table = classmethod(from_device_table)
    try:
        yield made
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)


def scorer_devices(scorer):
    """Devices that hold any of a scorer's arrays."""
    return {d for a in _device_arrays(vars(scorer)) for d in a.devices()}


def kcf_body(path):
    with open(path, "rb") as fh:
        return [ln for ln in fh if not ln.startswith(_STRIP)]


def screen(ds, tag, engines, extra, *, runs, platform, card):
    """Run getVariations ``runs`` times per engine; check each engine's
    KCFs against the hybrid engine's (run first, in this call or an
    earlier one) and each device scorer's placement. Returns
    {engine: (seconds per run, scorers)}."""
    n = len(ds["dbs"])
    names = [f"s{i}" for i in range(n)]
    base = os.path.join(ds["dir"], tag)
    results = {}
    for eng in engines:
        out = os.path.join(base, eng)
        os.makedirs(out, exist_ok=True)
        argv = ["getVariations", "-r", ds["ref"], "-k", ",".join(ds["dbs"]),
                "-s", ",".join(names),
                "-o", out if n > 1 else os.path.join(out, "s0.kcf"),
                "--engine", eng, "-t", "4", *extra]
        times = []
        with tracked_scorers() as made:
            for _ in range(runs):
                t0 = time.perf_counter()
                run_cli(argv)
                times.append(time.perf_counter() - t0)
        for s in made:
            devs = scorer_devices(s)
            if not devs or any(d.platform != platform for d in devs):
                raise AssertionError(
                    f"{tag}/{eng}: {type(s).__name__} arrays on {devs}")
        if eng == "hybrid" and made:
            raise AssertionError(f"{tag}/hybrid built device scorers")
        if eng != "hybrid" and not made:
            raise AssertionError(f"{tag}/{eng} built no device scorer")
        results[eng] = (times, made)
        ref_out = os.path.join(base, "hybrid")
        for s in names:
            if kcf_body(os.path.join(out, f"{s}.kcf")) != kcf_body(
                    os.path.join(ref_out, f"{s}.kcf")):
                raise AssertionError(f"{tag}: {eng} KCF {s} != hybrid")
        label = " ".join(
            f"{w}={t}s" for w, t in zip(("cold", "warm"), times)
        ) if runs > 1 else f"first={times[0]}s"
        kinds = ",".join(sorted({type(s).__name__ for s in made})) or "-"
        print(f"{tag}/{eng}: {label} scorers={kinds} identical=yes "
              f"[{card}]", flush=True)
    return results


def peak_memory_line(tag):
    import jax

    parts = []
    for d in jax.devices():
        st = d.memory_stats() or {}
        peak = st.get("peak_bytes_in_use")
        parts.append(f"{d.id}:" + (f"{peak / 2**30:.2f} GiB" if peak
                                   else "not reported"))
    print(f"{tag}: peak device memory so far " + " ".join(parts), flush=True)


# -- phases -------------------------------------------------------------


def phase_a(work, rng, *, platform, card, length=5_000_000, n_samples=8,
            window=5000):
    ds = build_dataset(work, "a", rng, length=length, n_samples=n_samples,
                       snp=0.01)
    screen(ds, "a", ["hybrid", "dprefix", "device"],
           ["-f", "window", "-w", str(window)],
           runs=2, platform=platform, card=card)
    return ds


def phase_b(ds, rng, *, platform, card, n_genes=1200):
    gtf = os.path.join(ds["dir"], "genes.gtf")
    write_gtf(gtf, ds["contig"], ds["genome"].shape[0], rng, n_genes)
    one = dict(ds, dbs=ds["dbs"][:1])
    screen(one, "b", ["hybrid", "device", "dprefix"],
           ["-f", "gene", "-g", gtf], runs=2, platform=platform, card=card)


def phase_c(work, rng, *, platform, card, length=40_000_000, n_samples=2,
            window=50_000, tag="c", contig="chr1"):
    ds = build_dataset(work, tag, rng, length=length, n_samples=n_samples,
                       snp=0.005, contig=contig)
    extra = ["-f", "window", "-w", str(window)]
    screen(ds, tag, ["hybrid"], extra, runs=1, platform=platform, card=card)
    for eng in ("device", "dprefix"):
        screen(ds, tag, [eng], extra, runs=1, platform=platform, card=card)
        peak_memory_line(f"{tag}/{eng}")
    return ds


def phase_d(ds):
    """The device join against a sorted-array dictionary lookup: the
    first sample's table, queried with every reference k-mer plus
    random misses."""
    from kcftools_tpu.engine.encode import canonicalize, pack_kmers
    from kcftools_tpu.ops.pjoin import build_pjoin_table, pjoin_lookup_np

    keys, counts = ds["first"]
    genome = ds["genome"]
    kmers, kv = pack_kmers(genome, np.ones(genome.shape[0], bool), K)
    rng = np.random.default_rng(1)
    q = np.concatenate([
        canonicalize(kmers[kv], K),
        rng.integers(0, 1 << (2 * K), kmers.shape[0] // 8, dtype=np.uint64),
    ])
    t0 = time.perf_counter()
    got = pjoin_lookup_np(build_pjoin_table(keys, counts, K), q)
    dt = time.perf_counter() - t0
    idx = np.minimum(np.searchsorted(keys, q), keys.shape[0] - 1)
    exp = np.where(keys[idx] == q, counts[idx], 0).astype(np.uint32)
    if not np.array_equal(got, exp):
        bad = int(np.count_nonzero(got != exp))
        raise AssertionError(f"d: {bad} of {q.shape[0]} join counts differ")
    print(f"d: join exact on {q.shape[0]:,} queries against "
          f"{keys.shape[0]:,} keys ({int((exp > 0).sum()):,} hits, "
          f"{dt:.3f} s with table build)", flush=True)


def phase_multi(work, rng, *, platform, card, n_dev, length=5_000_000,
                n_samples=8, window=5000):
    ds = build_dataset(work, "m", rng, length=length, n_samples=n_samples,
                       snp=0.01)
    res = screen(ds, "m", ["hybrid", "auto", "device"],
                 ["-f", "window", "-w", str(window)],
                 runs=2, platform=platform, card=card)
    from kcftools_tpu.engine.device_prefix import DevicePrefixScorer

    auto = res["auto"][1]
    if not auto or not all(isinstance(s, DevicePrefixScorer) for s in auto):
        raise AssertionError(f"m: --engine auto built {auto}")
    used = set().union(*(s.devices_used() for s in auto))
    rows = set().union(*(s.sample_rows_devices() for s in auto))
    print(f"m/auto: slabs on {len(used)} card(s), sample rows on "
          f"{len(rows)} card(s)", flush=True)
    if max(len(used), len(rows)) < 2:
        raise AssertionError("m: dprefix used one card")
    for s in res["device"][1]:
        devs = scorer_devices(s)
        if len(devs) != n_dev:
            raise AssertionError(
                f"m: {type(s).__name__} arrays on {devs} only")
    print(f"m/device: {len(res['device'][1])} scorer(s), each with arrays "
          f"on all {n_dev} cards", flush=True)
    peak_memory_line("m")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--large", action="store_true",
                      help="the 325 Mbp single-contig run only")
    mode.add_argument("--multi", action="store_true",
                      help="the multi-card run only")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="keep generated data here (default: a temporary "
                    "directory, removed at the end)")
    args = ap.parse_args(argv)

    import kcftools_tpu.jaxinit  # noqa: F401  (x64 + compile cache)
    import jax

    devs = jax.devices()
    platform = devs[0].platform
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {platform}",
              file=sys.stderr)
        return 1
    if args.multi and len(devs) < 2:
        print("chip_smoke: --multi needs more than one card", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)

    from kcftools_tpu.native import get_lib

    if get_lib() is None:
        raise RuntimeError("native host library failed to build or load")
    for var in ("KCFTOOLS_ENGINE", "KCFTOOLS_NO_DEVICE_PROBE"):
        os.environ.pop(var, None)

    work = args.workdir or tempfile.mkdtemp(prefix="kcf_smoke_")
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    kw = {"platform": platform, "card": card}
    t0 = time.perf_counter()
    try:
        if args.multi:
            phase_multi(work, rng, n_dev=len(devs), **kw)
        elif args.large:
            phase_c(work, rng, length=324_658_466, n_samples=1, tag="large",
                    contig="chr3", **kw)
        else:
            ds = phase_a(work, rng, **kw)
            phase_b(ds, rng, **kw)
            phase_d(ds)
            phase_c(work, rng, **kw)
    finally:
        if args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
