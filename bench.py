#!/usr/bin/env python
"""Benchmark: the getVariations hot path plus end-to-end command rungs.

Primary metric: windows scored per second per device on the per-sample
engine work (merge join + window statistics), E. coli-scale (5 Mbp,
k=31, 5 kb fixed windows, 8 samples) - the first ladder config. BOTH
engines are measured and the faster reported:

  - ``hybrid``  - pure-host path: native merge join + the ordinal-space
    scanner (one occurrence-map build per reference, then per sample
    sequential-stream presence/corrections + the bit-word gap walk -
    the engine the CLI uses for 12+-sample runs; window_scan_u8
    remains the fallback).
  - ``dprefix`` - device-resident scorer: the host performs the merge
    join and the ordinal-space pack (native kcf_ordpack - no
    positional gather), run-encodes presence (native kcf_bits_to_runs),
    and ships each group of up to 8 samples as ONE stacked transfer +
    ONE device execution per slab - the device reconstructs presence
    from the runs and replays the whole per-window gap-run state
    machine (GetVariants.java:202-261 semantics) as batched int32
    prefix scans.

Additional rungs, all timed on REAL FILES through the actual CLI entry
points (the command, not the kernel):

  - ``e2e``     - multi-sample getVariations wall-clock: KMC database
    ingest from disk -> scoring -> KCF files on disk (8 samples).
  - ``device``  - the same run with --engine device (on-device join).
  - ``rung20``  - the engine duel at 20 samples (rice-ladder sample
    count; the device dispatch amortizes across more samples).
  - ``gtf``     - gene-feature mode over a synthetic GTF (spliced
    feature windows, the A. thaliana-shaped rung).
  - ``pipeline``- cohort (8 single-sample KCFs -> 1) + findIBS
    --summary, the downstream sweep.
  - ``sharded`` - the mesh-sharded lookup path (ShardedWindowScorer)
    on an 8-virtual-CPU mesh with the table sharded 8 ways (a CPU
    subprocess; benchmarks/mesh_bench.py) - a count of overhead, not a
    device rate.
  - ``scaling`` - data-axis scaling at fixed total work on the virtual
    CPU mesh, plus the two-process jax.distributed cross-process
    efficiency (benchmarks/dist_bench.py), both on CPU devices.

The benchmark needs an accelerator and fails without one; every
subprocess it starts runs on the CPU, so this process alone holds the
device.

BASELINE HONESTY: the reference publishes no numbers and no JVM exists
in this image, so ``vs_baseline`` divides by an ESTIMATE of the Java
tool's throughput on a 24-thread host (~1.5 us/kmer/thread => ~16M
kmer/s => ~3200 windows/s at 5 kb windows). It is a modeled ratio, not
a measured one; ``baseline_estimated: true`` marks it in the output.
"""

import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

import kcftools_tpu  # noqa: F401  (enables x64 + compile cache)

from kcftools_tpu.engine.encode import canonicalize, pack_kmers
from kcftools_tpu.engine.prefix_scan import static_window_stats
from kcftools_tpu.engine.windows import tiling_windows
from kcftools_tpu.native import merge_counts_u8, window_scan_u8

from chip_smoke import write_fasta, write_gtf

GENOME_MBP = 5
K = 31
WINDOW = 5000
SNP_RATE = 0.01
N_SAMPLES = 8
N_SAMPLES_BIG = 20
BASELINE_WINDOWS_PER_SEC = 3200.0  # estimate; see module docstring


def _mutate(rng, genome):
    sample = genome.copy()
    snp = rng.random(genome.shape[0]) < SNP_RATE
    sample[snp] = (sample[snp] + rng.integers(1, 4, snp.sum())) % 4
    return sample


def _sample_db(rng, genome, base_valid):
    skmers, skv = pack_kmers(_mutate(rng, genome), base_valid, K)
    db_sorted, db_counts = np.unique(
        canonicalize(skmers[skv], K), return_counts=True
    )
    return db_sorted, db_counts.astype(np.uint32)


def _measure(sweep, rounds, work):
    sweep()  # warm (compiles on the device path; page faults on host)
    best = 0.0
    for _ in range(rounds):  # the shared host is noisy; best-of-many
        t0 = time.time()
        sweep()
        best = max(best, work / (time.time() - t0))
    return best


def _engine_duel(dbs, refk, r_idx, starts, ends, which, rounds=8):
    """Best-of windows/s for each engine over the given sample set.

    The hybrid engine is measured exactly as the CLI would run it at
    this sample count: the fused positional scan below
    hostscan.WORTH_SAMPLES, the ordinal-space scanner (occurrence map
    built once per reference, like the k-mer index itself) at or
    above it - so rung 1 (8 samples) exercises window_scan_u8 and
    rung20 exercises the scanner."""
    n_windows = len(starts)
    w_hi = (ends - K).astype(np.int32)
    work = len(dbs) * n_windows
    rates = {}

    if which in ("both", "hybrid"):
        out = np.empty(refk.size, np.uint8)
        from kcftools_tpu.engine.hostscan import (
            WORTH_SAMPLES,
            OrdinalWindowScanner,
        )

        scanner = (
            OrdinalWindowScanner(r_idx, starts, w_hi, K, 1)
            if len(dbs) >= WORTH_SAMPLES
            else None
        )

        def hybrid_sweep():
            tot = 0
            for db_sorted, db_counts in dbs:
                u8, ei, ev = merge_counts_u8(refk, db_sorted, db_counts, out=out)
                res = scanner.score(u8, ei, ev) if scanner else None
                if res is None:
                    res = window_scan_u8(
                        u8, ei, ev, r_idx, 1, K, starts, w_hi
                    )
                tot += int(res["observed"].sum())
            return tot

        rates["hybrid"] = _measure(hybrid_sweep, rounds, work)

    if which in ("both", "dprefix"):
        from kcftools_tpu.engine.device_prefix import DevicePrefixScorer

        scorer = DevicePrefixScorer(
            None, K, min_count=1, batch=min(len(dbs), 16)
        )
        scorer.add_chrom("c", r_idx, starts, ends)

        def dprefix_sweep():
            for si, (db_sorted, db_counts) in enumerate(dbs):
                scorer.submit(si, refk, db_sorted, db_counts)
            tot = 0
            for si in range(len(dbs)):
                res = scorer.collect(si)
                tot += int(res["c"]["observed"].sum())
                scorer.discard(si)
            return tot

        rates["dprefix"] = _measure(dprefix_sweep, rounds, work)
        scorer.close()
    return rates


def _refsim_rung(db_prefix, genome, starts, ends, db0, refk, r_idx,
                 threads=2, rounds=3):
    from kcftools_tpu.io.kmc import KMCReader, _build_norm

    r = KMCReader(db_prefix, materialize=False)
    suf_bytes = r.suffix_length // 4
    rec = suf_bytes + r.counter_size
    with open(r.suffix_file, "rb") as fh:
        fh.seek(4)
        raw = np.fromfile(fh, np.uint8, count=r.total_kmers * rec)
    norm = _build_norm(r.signature_length)
    from kcftools_tpu.native import refsim_scan

    args = (genome, K, starts, ends, r.signature_map,
            r.signature_length, r.prefix_array, r.lut_prefix_length,
            raw, r.total_kmers, suf_bytes, r.counter_size, norm, 1,
            threads)
    obs = refsim_scan(*args)
    # exactness gate: the simulated reference must agree with the
    # production engine before its rate may serve as the baseline
    out = np.empty(refk.size, np.uint8)
    u8, ei, ev = merge_counts_u8(refk, db0[0], db0[1], out=out)
    mine = window_scan_u8(u8, ei, ev, r_idx, 1, K, starts,
                          (ends - K).astype(np.int32))
    if not np.array_equal(obs, mine["observed"].astype(np.int64)):
        raise AssertionError("refsim observed mismatch vs engine")
    best = 0.0
    for _ in range(rounds):
        t0 = time.time()
        refsim_scan(*args)
        best = max(best, len(starts) / (time.time() - t0))
    return {
        "refsim_windows_per_sec": round(best, 1),
        "refsim_threads": threads,
    }


def _lookup_rung(n_keys=1 << 22, n_q=1 << 22, rounds=10):
    import jax

    from kcftools_tpu.ops.pjoin import (
        build_pjoin_table,
        pjoin_lookup_fn,
        route_queries,
    )

    rng = np.random.default_rng(42)
    keys = np.unique(
        rng.integers(0, 1 << (2 * K), n_keys + n_keys // 4, dtype=np.uint64)
    )[:n_keys]
    counts = rng.integers(1, 255, keys.shape[0]).astype(np.uint32)
    tbl = build_pjoin_table(keys, counts, K)
    q = np.concatenate(
        [rng.choice(keys, n_q // 2),
         rng.integers(0, 1 << (2 * K), n_q // 2, dtype=np.uint64)]
    )
    qh, ql, src = route_queries(q, K, tbl.P)
    fn = pjoin_lookup_fn(tbl.P, qh.shape[1], tbl.tile)
    dqh, dql = jax.device_put(qh), jax.device_put(ql)
    dth = jax.device_put(tbl.th)
    dtl = jax.device_put(tbl.tl)
    dtc = jax.device_put(tbl.tc)

    # exactness first: searchsorted oracle, full query set
    out = np.asarray(fn(dqh, dql, dth, dtl, dtc))
    res = np.zeros(q.shape[0], np.uint32)
    live = src >= 0
    res[src[live]] = out[live]
    idx = np.minimum(np.searchsorted(keys, q), keys.shape[0] - 1)
    exp = np.where(keys[idx] == q, counts[idx], 0).astype(np.uint32)
    if not np.array_equal(res, exp):
        raise AssertionError("pjoin lookup mismatch vs sorted oracle")

    # one call per timing, each awaited: identical calls chained in
    # one program could be merged by the compiler
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(dqh, dql, dth, dtl, dtc))
        times.append(time.perf_counter() - t0)
    rate = q.shape[0] / float(np.median(times))
    return {
        "lookup_per_sec_device": round(rate),
        "lookup_table_keys": int(keys.shape[0]),
        "lookup_kernel": "xla_all_pairs",
    }


def _cli(argv):
    """Run a CLI subcommand with its stdout logging diverted to stderr
    (bench stdout must stay a single JSON line)."""
    from kcftools_tpu.cli import main as cli_main

    with contextlib.redirect_stdout(sys.stderr):
        rc = cli_main(argv)
    if rc != 0:
        raise RuntimeError(f"command failed: {argv[:2]}")


def main():
    import jax

    devs = jax.devices()
    if devs[0].platform == "cpu":
        sys.stderr.write("bench.py needs an accelerator; JAX found only "
                         "the CPU\n")
        return 1
    rng = np.random.default_rng(0)
    n = GENOME_MBP * 1_000_000
    genome = rng.integers(0, 4, size=n).astype(np.uint8)
    base_valid = np.ones(n, bool)

    # reference k-mer index + window plan (one-time, excluded: amortizes
    # across samples exactly as RefKmerIndex.load_or_build does)
    kmers, kv = pack_kmers(genome, base_valid, K)
    canon = canonicalize(kmers, K)
    refk = np.unique(canon[kv])
    r_idx = np.searchsorted(refk, canon).astype(np.int32)
    r_idx[~kv] = -1
    starts, ends = tiling_windows(n, WINDOW, K)
    static_window_stats(r_idx, base_valid, K, starts, ends)
    n_windows = len(starts)

    dbs = [_sample_db(rng, genome, base_valid) for _ in range(N_SAMPLES_BIG)]

    which = os.environ.get("BENCH_ENGINE", "both")
    rungs = set(
        os.environ.get(
            "BENCH_RUNGS",
            "duel,rung20,e2e,device,lookup,refsim,gtf,pipeline,"
            "sharded,scaling",
        ).split(",")
    )

    result = {
        "metric": "windows_scored_per_sec_per_chip",
        "unit": "windows/s (5kb windows, k=31, 8 samples)",
        "n_windows": n_windows,
        "baseline_estimated": True,
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
    }

    # -- rung 1: engine duel, 8 samples (headline) --------------------------
    rates = _engine_duel(dbs[:N_SAMPLES], refk, r_idx, starts, ends, which)
    engine = max(rates, key=rates.get)
    best = rates[engine]
    result["value"] = round(best, 1)
    result["vs_baseline"] = round(best / BASELINE_WINDOWS_PER_SEC, 2)
    result["engine"] = engine
    result["kmer_lookups_per_sec"] = round(best * (WINDOW - K + 1))
    for name, rate in rates.items():
        result[f"{name}_windows_per_sec"] = round(rate, 1)
        result[f"{name}_vs_baseline_est"] = round(
            rate / BASELINE_WINDOWS_PER_SEC, 2
        )

    # -- rung 2: engine duel, 20 samples (rice-ladder sample count) ---------
    if "rung20" in rungs:
        r20 = _engine_duel(dbs, refk, r_idx, starts, ends, which, rounds=4)
        for name, rate in r20.items():
            result[f"rung20_{name}_windows_per_sec"] = round(rate, 1)

    # -- file-based rungs ---------------------------------------------------
    tmp = tempfile.mkdtemp(prefix="kcfbench_")
    try:
        from kcftools_tpu.io.kmc import write_kmc_db

        ref_fa = os.path.join(tmp, "ref.fa")
        write_fasta(ref_fa, "chr1", genome)
        db_prefixes = []
        for i in range(N_SAMPLES):
            p = os.path.join(tmp, f"s{i}")
            write_kmc_db(p, dbs[i][0], dbs[i][1], K, counter_size=1)
            db_prefixes.append(p)

        if "e2e" in rungs:
            # multi-sample getVariations: KMC ingest -> score -> KCF
            # files. Cold includes the one-time reference k-mer index
            # build; warm reuses its on-disk cache (the steady state for
            # repeated screenings against one reference).
            out_dir = os.path.join(tmp, "kcf")
            argv = [
                "getVariations", "-r", ref_fa,
                "-k", ",".join(db_prefixes),
                "-o", out_dir,
                "-s", ",".join(f"s{i}" for i in range(N_SAMPLES)),
                "-f", "window", "-w", str(WINDOW), "-t", "2",
            ]
            t0 = time.time()
            _cli(argv)
            cold = time.time() - t0
            stage_json = os.path.join(tmp, "stages.json")
            os.environ["KCFTOOLS_STAGE_JSON"] = stage_json
            try:
                t0 = time.time()
                _cli(argv)
                warm = time.time() - t0
            finally:
                os.environ.pop("KCFTOOLS_STAGE_JSON", None)
            result["e2e_cold_seconds"] = round(cold, 2)
            result["e2e_seconds"] = round(warm, 2)
            result["e2e_windows_per_sec"] = round(
                N_SAMPLES * n_windows / warm, 1
            )
            try:
                with open(stage_json) as fh:
                    result["e2e_stage_seconds"] = json.load(fh)
            except OSError:
                pass

        if "device" in rungs:
            # the device-join engine (--engine device): each sample's
            # sorted table ships to the device as quantile tiles and the
            # merge join runs there (partitioned all-pairs join), with the
            # positional gap scan on device and only per-window stats
            # fetched. Same sample count as the e2e rung so the two
            # wall-clocks compare engine against engine. Warm = second
            # run (cached reference index + compiled programs), the
            # steady state for repeated screenings.
            out_dir = os.path.join(tmp, "kcf_dev")
            argv = [
                "getVariations", "-r", ref_fa,
                "-k", ",".join(db_prefixes),
                "-o", out_dir,
                "-s", ",".join(f"s{i}" for i in range(N_SAMPLES)),
                "-f", "window", "-w", str(WINDOW), "-t", "2",
            ]
            os.environ["KCFTOOLS_ENGINE"] = "device"
            try:
                t0 = time.time()
                _cli(argv)
                cold = time.time() - t0
                t0 = time.time()
                _cli(argv)
                warm = time.time() - t0
            finally:
                os.environ.pop("KCFTOOLS_ENGINE", None)
            result["device_e2e_cold_seconds"] = round(cold, 2)
            result["device_e2e_seconds"] = round(warm, 2)
            result["device_e2e_windows_per_sec"] = round(
                N_SAMPLES * n_windows / warm, 1
            )

        if "refsim" in rungs:
            # MEASURED Java-baseline stand-in: the reference's exact
            # lookup mechanics (char-by-char k-mer repack, revcomp
            # canonicalization, signature scan, prefix-LUT + suffix
            # binary search, one thread-pool task per window;
            # KMC.java:292-326, GetVariants.java:129-261) transcribed
            # to C++ and run on THIS host against the same s0 database
            # and window set. C++ >= JVM speed, so vs_baseline_measured
            # (champion / refsim rate) is a conservative multiplier on
            # identical hardware - replacing the modeled ~3200 w/s
            # 24-thread estimate that baseline_estimated flags.
            try:
                result.update(_refsim_rung(
                    db_prefixes[0], genome, starts, ends, dbs[0], refk,
                    r_idx,
                ))
                if "refsim_windows_per_sec" in result:
                    result["vs_baseline_measured"] = round(
                        result["value"]
                        / result["refsim_windows_per_sec"], 2
                    )
            except Exception as e:
                sys.stderr.write(f"refsim rung failed: {e}\n")

        if "lookup" in rungs and which in ("both", "dprefix"):
            # isolated ON-DEVICE lookup rate of the partitioned join
            # (ops/pjoin.py) - the device replacement for the
            # reference's per-query signature scan + prefix LUT +
            # suffix binary search (Data/KMC.java:292-326). Keys and
            # queries are device-resident; transfers excluded by
            # design: this rung isolates the join the same way
            # kmer_lookups_per_sec isolates the host merge join.
            result.update(_lookup_rung())

        if "gtf" in rungs:
            gtf_path = os.path.join(tmp, "genes.gtf")
            write_gtf(gtf_path, "chr1", n, rng)
            out_kcf = os.path.join(tmp, "gene.kcf")
            t0 = time.time()
            _cli(
                [
                    "getVariations", "-r", ref_fa, "-k", db_prefixes[0],
                    "-o", out_kcf, "-s", "s0", "-f", "gene",
                    "-g", gtf_path, "-t", "2",
                ]
            )
            dt = time.time() - t0
            with open(out_kcf) as fh:
                n_feat = sum(1 for l in fh if not l.startswith("#"))
            result["gtf_seconds"] = round(dt, 2)
            result["gtf_features_per_sec"] = round(n_feat / dt, 1)

        if "sharded" in rungs:
            # the wheat-scale mesh lookup path (ShardedWindowScorer) on
            # the 8-virtual-CPU mesh with the table sharded 8 ways (the
            # shard-local placement + psum program). A CPU subprocess:
            # this process holds the device.
            import subprocess

            env = dict(os.environ)
            env["KCFTOOLS_MESH_PLATFORM"] = "cpu"
            env["PYTHONPATH"] = os.pathsep.join(
                [os.path.dirname(os.path.abspath(__file__))]
                + env.get("PYTHONPATH", "").split(os.pathsep)
            )
            p = subprocess.run(
                [sys.executable, "benchmarks/mesh_bench.py", "--mode",
                 "sharded", "--windows", "256", "--rounds", "3"],
                capture_output=True, text=True, timeout=560,
                cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            )
            try:
                vm = json.loads(p.stdout.strip().splitlines()[-1])
                result["sharded_vmesh8_windows_per_sec"] = vm[
                    "sharded_windows_per_sec"]
            except Exception:
                sys.stderr.write(p.stdout[-2000:] + p.stderr[-2000:])

        if "scaling" in rungs:
            import subprocess

            env = dict(os.environ)
            env["KCFTOOLS_MESH_PLATFORM"] = "cpu"
            env["PYTHONPATH"] = os.pathsep.join(
                [os.path.dirname(os.path.abspath(__file__))]
                + env.get("PYTHONPATH", "").split(os.pathsep)
            )
            p = subprocess.run(
                [sys.executable, "benchmarks/mesh_bench.py", "--mode",
                 "scaling", "--windows", "512", "--rounds", "5"],
                capture_output=True, text=True, timeout=560,
                cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            )
            try:
                sc = json.loads(p.stdout.strip().splitlines()[-1])
                # medians with dispersion, efficiency bounded at 1 by
                # construction (see benchmarks/mesh_bench.py) - a
                # best-of metric on this noisy host once recorded
                # efficiencies above 1.0
                result["scaling_data_axis_efficiency"] = [
                    c["modeled_efficiency"] for c in sc["data_curve"]
                ]
                result["scaling_data_axis_stats"] = sc["data_curve"]
            except Exception:
                pass
            p = subprocess.run(
                [sys.executable, "benchmarks/mesh_bench.py", "--mode",
                 "dprefix_samples", "--rounds", "5"],
                capture_output=True, text=True, timeout=560,
                cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            )
            try:
                sa = json.loads(p.stdout.strip().splitlines()[-1])
                result["sample_axis_efficiency"] = sa[
                    "sample_axis_efficiency"]
                result["sample_rows_devices"] = sa["sample_rows_devices"]
            except Exception:
                pass
            denv = dict(os.environ)
            # production-shaped batches: the loopback-gRPC hop costs a
            # fixed ~60 ms per batch, which 256-window toy batches
            # cannot amortize (they read ~0.76); 1024 windows is the
            # smallest realistic screening batch
            denv.setdefault("KCFTOOLS_DIST_WINDOWS", "1024")
            p = subprocess.run(
                [sys.executable, "benchmarks/dist_bench.py"],
                capture_output=True, text=True, timeout=560,
                cwd=os.path.dirname(os.path.abspath(__file__)),
                env=denv,
            )
            try:
                d = json.loads(p.stdout.strip().splitlines()[-1])
                result["cross_process_efficiency"] = d[
                    "cross_process_efficiency"]
                result["cross_process_stats"] = {
                    key: v for key, v in d.items()
                    if key.endswith(("_median", "_min", "_max"))
                    or key == "rounds"
                }
            except Exception:
                pass

        if "pipeline" in rungs and "e2e" in rungs:
            coh = os.path.join(tmp, "cohort.kcf")
            ibs = os.path.join(tmp, "ibs")
            t0 = time.time()
            _cli(
                [
                    "cohort", "-o", coh,
                    "-i", ",".join(
                        os.path.join(tmp, "kcf", f"s{i}.kcf")
                        for i in range(N_SAMPLES)
                    ),
                ]
            )
            _cli(["findIBS", "-i", coh, "-o", ibs, "--summary"])
            dt = time.time() - t0
            result["pipeline_seconds"] = round(dt, 2)
            result["pipeline_windows_per_sec"] = round(n_windows / dt, 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
