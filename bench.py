"""Benchmark: END-TO-END (count + correct) reads/s on one GPU.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", ...}
(extra fields carry the per-pass rates, the counting tail anatomy and
the device it ran on).  Fails when JAX finds no GPU.
Baseline anchor: reference bfc -t16 on NA12878 human reads sustains
~42k reads/s through BOTH passes on a 20-core E5-2660 (BASELINE.md:
889.5M reads / 21,060 s total wall time, so end-to-end is the honest
comparison).  Per-pass rates go to stderr.

The counting pass runs through the PRODUCTION path: a real FASTQ file
via the native batched reader (count_file_device), exactly what the
CLI drives.  Compile time is excluded (a warm-up pass touches every
jit shape first): the anchor excludes compilation too, and the cost
amortizes to zero at production scale.

Environment knobs:
  BENCH_GENOME   genome length  [500000]
  BENCH_COVERAGE fold coverage  [60]
  BENCH_READLEN  read length    [100]
  BENCH_K        k-mer length   [25]
  BENCH_BATCH    correction batch size [8192]
  BENCH_COUNT_BATCH  counting batch size [16384]
  BENCH_REPEAT_FRAC  fraction of genome overwritten with repeats [0.1]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

BASELINE_READS_PER_S = 42_000.0


def synth_reads(glen: int, n_reads: int, rlen: int, seed: int = 1234,
                rep_frac: float = 0.1, err_rate: float = 0.01,
                n_rate: float = 0.0):
    """Seeded Illumina-like reads: (bases u8 [n, rlen] with 0-3 = ACGT and
    4 = N, Phred+33 qualities u8 [n, rlen]).

    The genome is uniform random with `rep_frac` of it overwritten by
    copies of earlier 2 kb segments (a uniform genome flatters the
    search's heap statistics; real genomes have repeats).  Half the reads
    are reverse complemented; substitution errors carry low qualities
    (Q2-14), correct bases Q30-39."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, glen).astype(np.uint8)
    seg = 2000
    for _ in range(int(glen * rep_frac) // seg):
        src = int(rng.integers(0, glen - seg))
        dst = int(rng.integers(0, glen - seg))
        g[dst:dst + seg] = g[src:src + seg]
    bases = np.empty((n_reads, rlen), np.uint8)
    quals = np.empty((n_reads, rlen), np.uint8)
    step = 1 << 18  # bounded temporaries at large read counts
    for lo in range(0, n_reads, step):
        n = min(step, n_reads - lo)
        starts = rng.integers(0, glen - rlen, n)
        mat = g[starts[:, None] + np.arange(rlen)[None, :]]
        rc = rng.random(n) < 0.5
        mat[rc] = 3 - mat[rc, ::-1]
        err = rng.random((n, rlen), dtype=np.float32) < err_rate
        mat = np.where(err, (mat + rng.integers(1, 4, mat.shape)) % 4, mat)
        if n_rate:
            mat = np.where(rng.random((n, rlen), dtype=np.float32) < n_rate,
                           4, mat)
        bases[lo:lo + n] = mat
        quals[lo:lo + n] = np.where(
            err, 33 + 2 + rng.integers(0, 13, mat.shape),
            33 + 30 + rng.integers(0, 10, mat.shape))
    return bases, quals


def write_fastq(path: str, bases: np.ndarray, quals: np.ndarray,
                lo: int = 0, hi: int = -1) -> None:
    """Write reads [lo, hi) as FASTQ records named r<index>."""
    hi = len(bases) if hi < 0 else hi
    text = np.frombuffer(b"ACGTN", np.uint8)[bases[lo:hi]]
    q = quals[lo:hi]
    with open(path, "wb") as f:
        for i in range(hi - lo):
            f.write(b"@r%d\n%s\n+\n%s\n"
                    % (lo + i, text[i].tobytes(), q[i].tobytes()))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.stderr.write(f"[bench] needs a GPU; JAX found {dev.platform}\n")
        return 1
    card = card_line()

    from bfc_jax.models import corrector as DC
    from bfc_jax.models import counter as C
    from bfc_jax.opts import Opts

    glen = int(os.environ.get("BENCH_GENOME", 500_000))
    cov = int(os.environ.get("BENCH_COVERAGE", 60))
    rlen = int(os.environ.get("BENCH_READLEN", 100))
    k = int(os.environ.get("BENCH_K", 25))
    batch = int(os.environ.get("BENCH_BATCH", 8192))
    cbatch = int(os.environ.get("BENCH_COUNT_BATCH", 16384))
    rep_frac = float(os.environ.get("BENCH_REPEAT_FRAC", "0.1"))

    sys.stderr.write(f"[bench] generating genome={glen} cov={cov}x len={rlen}\n")
    n_reads = glen * cov // rlen
    mat, qmat = synth_reads(glen, n_reads, rlen, rep_frac=rep_frac)
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    reads = [
        (acgt[mat[i]].tobytes().decode(), qmat[i].tobytes().decode())
        for i in range(n_reads)
    ]

    opt = Opts()
    opt.k = k
    opt.bf_shift = max(20, glen.bit_length() + 7)

    # whole batches only: a ragged tail would compile a second batch
    # shape inside the timed region on a cold cache
    n_use = max(n_reads // batch * batch, min(n_reads, batch))

    tdir = tempfile.mkdtemp(prefix="bfc_bench_")
    fq_warm = os.path.join(tdir, "warm.fq")
    fq_main = os.path.join(tdir, "main.fq")
    write_fastq(fq_warm, mat, qmat, 0, min(cbatch, n_use))
    write_fastq(fq_main, mat, qmat, 0, n_use)

    # ---- warm-up: compile every jit shape outside the timed region,
    # INCLUDING the background merge-cap ladder (the timed stream would
    # otherwise stall on mid-stream merge compiles).
    t0 = time.time()
    C.count_file_device(fq_warm, opt, batch_reads=cbatch)
    C.await_merge_ladder()
    # one untimed FULL-size pass: the first pass of a process pays
    # one-time costs the small warm pass does not reach (big-pull slice
    # compiles + first-touch page faults on the multi-MB host buffers)
    C.count_file_device(fq_main, opt, batch_reads=cbatch)
    sys.stderr.write(f"[bench] counting warm-up (compile): {time.time() - t0:.1f}s\n")

    # ---- counting pass (timed): the production native-reader path
    t0 = time.time()
    ds = C.count_file_device(fq_main, opt, batch_reads=cbatch)
    t_count = time.time() - t0
    tail = dict(C.TAIL_TIMINGS)
    sys.stderr.write(
        f"[bench] counting: {n_use} reads in {t_count:.1f}s = "
        f"{n_use / t_count:.0f} reads/s ({ds.n_entries} distinct k-mers; "
        f"tail {tail})\n"
    )

    corr = DC.Corrector(opt, ds)
    lens_all = np.full((n_use,), rlen, np.int32)
    has_q = np.ones((n_use,), bool)
    t0 = time.time()
    # both hot programs (soft main pass + full-cap straggler shape)
    # compile in parallel threads
    corr.prewarm(batch, read_len=rlen)
    sys.stderr.write(f"[bench] correction warm-up (compile): {time.time() - t0:.1f}s\n")
    # one untimed FULL-size pass, for the same reason as counting's
    t0 = time.time()
    corr.correct_many(
        mat[:n_use], qmat[:n_use], lens_all, has_q, lambda i: reads[i],
        batch, bucketed=os.environ.get("BENCH_BUCKETED", "1") == "1",
        as_arrays=True,
    )
    sys.stderr.write(f"[bench] correction warm-up (pass): {time.time() - t0:.1f}s\n")

    # ---- correction pass (timed)
    t0 = time.time()
    res = corr.correct_many(
        mat[:n_use], qmat[:n_use], lens_all, has_q, lambda i: reads[i], batch,
        bucketed=os.environ.get("BENCH_BUCKETED", "1") == "1",
        as_arrays=True,  # the production path (native batch formatter)
    )
    n_done = len(res) if isinstance(res, list) else res.n
    t_corr = time.time() - t0
    assert n_done == n_use
    sys.stderr.write(
        f"[bench] correction: {n_done} reads in {t_corr:.1f}s = "
        f"{n_done / t_corr:.0f} reads/s\n"
    )
    rps = n_use / (t_count + t_corr)
    sys.stderr.write(
        f"[bench] end-to-end: {n_use} reads in {t_count + t_corr:.1f}s = "
        f"{rps:.0f} reads/s\n"
    )
    print(json.dumps({
        "metric": "end_to_end_reads_per_s_per_chip",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / BASELINE_READS_PER_S, 3),
        "count_reads_per_s": round(n_use / t_count, 1),
        "correct_reads_per_s": round(n_use / t_corr, 1),
        "count_s": round(t_count, 2),
        "correct_s": round(t_corr, 2),
        "count_tail_s": tail,
        "n_reads": n_use,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
