"""Smoke run of bfc-jax on the GPU: device, parity, full size, mesh.

    python chip_smoke.py            # phases 0-2 on one GPU
    python chip_smoke.py --mesh4    # phase 3 alone, on four GPUs

Everything runs in this one process, which owns the card(s); the CLI is
driven in process through bfc_jax.cli.main with stdout sent to a file.
Lines before the last give phase wall times, rates, compile time, peak
device memory, LSM spills and scalar-fallback counts, each beside the
card's name and power limit from nvidia-smi.  The last line is one JSON
object {"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
N}}.  A failed check raises, so the script exits non-zero and prints no
result; so does a run in which JAX finds no GPU.

Phases 1-3 are plain functions with size parameters, so they can be
rehearsed on the CPU (JAX_PLATFORMS=cpu, and for phase 3
XLA_FLAGS=--xla_force_host_platform_device_count=4); only main() insists
on a GPU.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

CARD = "card not queried"  # nvidia-smi "name, power.limit"; set by main()


def report(msg: str) -> None:
    print(f"[smoke] {msg} | {CARD}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peak_bytes(i: int = 0):
    import jax

    stats = jax.devices()[i].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def run_cli(argv, out_path: str, log_path: str, env=None) -> float:
    """bfc_jax.cli.main(argv) in this process, stdout to out_path and
    stderr to log_path, with `env` set for the call; returns wall
    seconds.  A non-zero exit raises with the log's tail."""
    from bfc_jax import cli

    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    old_out, old_err = sys.stdout, sys.stderr
    t0 = time.time()
    try:
        with open(out_path, "wb") as fo, open(log_path, "w") as fe:
            sys.stdout = io.TextIOWrapper(fo, encoding="latin-1",
                                          write_through=True)
            sys.stderr = fe
            try:
                rc = cli.main(list(argv))
                sys.stdout.flush()
            finally:
                sys.stdout.detach()
                sys.stdout, sys.stderr = old_out, old_err
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.time() - t0
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-3000:]
        raise RuntimeError(f"bfc-jax {' '.join(argv)} exited {rc}:\n{tail}")
    return wall


def scalar_fallbacks(log_path: str) -> int:
    with open(log_path) as f:
        m = re.findall(r"(\d+) reads took the scalar fallback", f.read())
    return sum(int(x) for x in m)


def records(path: str):
    """FASTQ records of a file as lists of 4 byte lines (no newline)."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    if len(lines) % 4:
        raise AssertionError(f"{path}: {len(lines)} lines, not 4 per record")
    return [lines[i:i + 4] for i in range(0, len(lines), 4)]


_SEQ = re.compile(rb"^[ACGTNacgtn]*$")


def check_wellformed(recs, tag: bool) -> None:
    """Every record is @name[\\tcomment] / bases / + / qualities of the
    same length; with tag, the comment is the ec:Z: stats tag."""
    for r in recs:
        head, seq, plus, qual = r
        name, _, comment = head.partition(b"\t")
        ok = (name.startswith(b"@r") and plus == b"+"
              and len(seq) == len(qual) and _SEQ.match(seq) is not None
              and (not tag or comment.startswith(b"ec:Z:")))
        if not ok:
            raise AssertionError(f"malformed record: {r!r}")


def first_difference(a: str, b: str) -> str:
    ra, rb = records(a), records(b)
    for i, (x, y) in enumerate(zip(ra, rb)):
        if x != y:
            return f"record {i}: {x!r} != {y!r}"
    return f"record counts {len(ra)} != {len(rb)}"


def assert_same(a: str, b: str, what: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError(f"{what}: {a} != {b}; "
                                 f"{first_difference(a, b)}")


# ---------------------------------------------------------------- phase 0
def phase0() -> None:
    """The device, the native I/O library and the compile cache."""
    import jax

    import bfc_jax  # noqa: F401  (applies the compile-cache rule)
    from bfc_jax.native.build import get_lib

    devs = jax.devices()
    if get_lib() is None:
        raise RuntimeError("the native I/O library did not build or load")
    report(f"phase 0: device {devs[0].platform} {devs[0].device_kind} "
           f"x{len(devs)}; native I/O library loaded; compile cache "
           f"{jax.config.jax_compilation_cache_dir}")


# ---------------------------------------------------------------- phase 1
def phase1(work: str, genome: int = 20_000, n_reads: int = 3000,
           spill_cap: int = 1 << 12, spill_chunk: str = "100k") -> None:
    """Device path vs the scalar model (models/pipeline.run, the
    semantic spec), byte for byte, in every mode: correction, trim,
    count+dump then restore, refine, and correction with the merge cap
    forced low enough to spill the counting tree to the host (-L cuts
    the stream into several counting batches, so the tree merges)."""
    import bench
    from bfc_jax.models import counter as C

    fq = os.path.join(work, "p1.fq")
    b, q = bench.synth_reads(genome, n_reads, 100, seed=7, n_rate=0.0005)
    bench.write_fastq(fq, b, q)
    kb = ["-k17", "-b22"]

    def p(name):
        return os.path.join(work, name)

    def pair(name, args, dev_args=None):
        t_dev = run_cli(kb + (dev_args or args), p(name + ".dev"),
                        p(name + ".dev.log"))
        t_sca = run_cli(["--scalar"] + kb + args, p(name + ".sca"),
                        p(name + ".sca.log"))
        assert_same(p(name + ".dev"), p(name + ".sca"), f"phase 1 {name}")
        return t_dev, t_sca

    t_cold, t_sca = pair("correct", [fq])
    t_warm = run_cli(kb + [fq], p("correct.dev2"), p("correct.dev2.log"))
    assert_same(p("correct.dev2"), p("correct.sca"), "phase 1 correct (warm)")
    n_fb = scalar_fallbacks(p("correct.dev.log"))
    report(f"phase 1 correct: identical; device cold {t_cold:.2f}s, warm "
           f"{t_warm:.2f}s (compile/warm-up ~{t_cold - t_warm:.2f}s), "
           f"scalar model {t_sca:.2f}s; {n_reads / t_warm:.0f} reads/s warm; "
           f"{n_fb} scalar fallbacks")

    t_dev, t_sca = pair("trim", ["-1", fq])
    report(f"phase 1 trim -1: identical; device {t_dev:.2f}s, scalar "
           f"{t_sca:.2f}s")

    t_dev = run_cli(kb + ["-E", "-d", p("dump.dev"), fq], p("dump.dev.out"),
                    p("dump.dev.log"))
    t_sca = run_cli(["--scalar"] + kb + ["-E", "-d", p("dump.sca"), fq],
                    p("dump.sca.out"), p("dump.sca.log"))
    assert_same(p("dump.dev.out"), p("dump.sca.out"), "phase 1 -E stdout")
    assert_same(p("dump.dev"), p("dump.sca"), "phase 1 -d dump")
    t_r_dev = run_cli(["-r", p("dump.dev"), fq], p("restore.dev"),
                      p("restore.dev.log"))
    t_r_sca = run_cli(["--scalar", "-r", p("dump.sca"), fq],
                      p("restore.sca"), p("restore.sca.log"))
    assert_same(p("restore.dev"), p("restore.sca"), "phase 1 -r")
    report(f"phase 1 -E -d / -r: dumps and outputs identical; device "
           f"{t_dev:.2f}s + {t_r_dev:.2f}s, scalar {t_sca:.2f}s + "
           f"{t_r_sca:.2f}s")

    t_dev, t_sca = pair("refine", ["-R", fq, p("correct.sca")])
    report(f"phase 1 refine -R: identical; device {t_dev:.2f}s, scalar "
           f"{t_sca:.2f}s")

    t_dev = run_cli(kb + ["-L", spill_chunk, fq], p("spill.dev"),
                    p("spill.dev.log"),
                    env={"BFC_MAX_MERGE_CAP": str(spill_cap)})
    spills = C.TAIL_TIMINGS.get("spills", 0)
    assert_same(p("spill.dev"), p("correct.sca"), "phase 1 forced spill")
    if not spills:
        raise AssertionError("phase 1 forced spill: the tree never spilled")
    report(f"phase 1 forced spill (merge cap {spill_cap}): identical; "
           f"{spills} LSM spills; device {t_dev:.2f}s; peak device bytes "
           f"{peak_bytes()}")


# ---------------------------------------------------------------- phase 2
def phase2(work: str, genome: int = 4_600_000, coverage: int = 30,
           read_len: int = 100, sample: int = 2000,
           size_arg: str = "5m") -> None:
    """E. coli-sized run through `-s 5m -d spec.hash reads.fq`, then a
    seeded sample re-corrected by the scalar model against the dumped
    spectrum, then trim on the same file.

    Cuts: 30x coverage where bacterial runs are usually 50-100x, and
    synthetic reads (seeded genome with 10% repeats, ~1% substitution
    errors on low-quality bases) because the repo carries no dataset."""
    import numpy as np

    import bench
    from bfc_jax.models import counter as C

    n = genome * coverage // read_len
    fq = os.path.join(work, "p2.fq")
    t0 = time.time()
    b, q = bench.synth_reads(genome, n, read_len, seed=11)
    bench.write_fastq(fq, b, q)
    report(f"phase 2 data: {n} reads x {read_len} bp, genome {genome} in "
           f"{time.time() - t0:.1f}s (set-up)")

    out = os.path.join(work, "p2.out")
    spec_hash = os.path.join(work, "spec.hash")
    t = run_cli(["-s", size_arg, "-d", spec_hash, fq], out,
                os.path.join(work, "p2.log"))
    spills = C.TAIL_TIMINGS.get("spills", 0)
    n_fb = scalar_fallbacks(os.path.join(work, "p2.log"))
    recs = records(out)
    if len(recs) != n:
        raise AssertionError(f"phase 2: {n} records in, {len(recs)} out")
    check_wellformed(recs, tag=True)
    report(f"phase 2 count+correct -s {size_arg}: {t:.2f}s wall, "
           f"{n / t:.0f} reads/s (compile included); {len(recs)} records "
           f"out, all well-formed with ec:Z:; {spills} LSM spills; {n_fb} "
           f"scalar fallbacks; peak device bytes {peak_bytes()}")

    rng = np.random.default_rng(2000)
    idx = np.sort(rng.choice(n, size=min(sample, n), replace=False))
    sfq = os.path.join(work, "p2.sample.fq")
    with open(sfq, "wb") as f:
        for i in idx:
            f.write(b"\n".join(_input_record(b, q, int(i))) + b"\n")
    sout = os.path.join(work, "p2.sample.sca")
    t_s = run_cli(["--scalar", "-r", spec_hash, sfq], sout,
                  os.path.join(work, "p2.sample.log"))
    srecs = records(sout)
    for j, i in enumerate(idx):
        if srecs[j] != recs[int(i)]:
            raise AssertionError(f"phase 2 read r{int(i)}: device "
                                 f"{recs[int(i)]!r} != scalar {srecs[j]!r}")
    del recs, srecs
    report(f"phase 2 sample: {len(idx)} seeded records byte-identical to "
           f"the scalar model under -r ({t_s:.2f}s)")

    tout = os.path.join(work, "p2.trim")
    t = run_cli(["-s", size_arg, "-1", fq], tout,
                os.path.join(work, "p2.trim.log"))
    trecs = records(tout)
    if len(trecs) > n:
        raise AssertionError(f"phase 2 trim: {len(trecs)} records out of {n}")
    check_wellformed(trecs, tag=False)
    report(f"phase 2 trim -1: {t:.2f}s wall, {n / t:.0f} reads/s; "
           f"{len(trecs)} of {n} records kept; peak device bytes "
           f"{peak_bytes()}")


def _input_record(bases, quals, i: int):
    import numpy as np

    text = np.frombuffer(b"ACGTN", np.uint8)[bases[i]].tobytes()
    return [b"@r%d" % i, text, b"+", quals[i].tobytes()]


# ---------------------------------------------------------------- phase 3
def phase3(work: str, n_dev: int = 4, genome: int = 500_000,
           coverage: int = 60, profile_reads: int = 40_000) -> None:
    """One card vs `--mesh n_dev` with the replicated table vs the
    sharded table: byte-identical outputs, data spread over every
    device, and the all_to_all time of a short profiled mesh run."""
    import jax

    import bench

    devs = jax.devices()
    if len(devs) < n_dev:
        raise RuntimeError(f"phase 3 needs {n_dev} devices, found {len(devs)}")
    n = genome * coverage // 100
    fq = os.path.join(work, "p3.fq")
    b, q = bench.synth_reads(genome, n, 100, seed=13)
    bench.write_fastq(fq, b, q)
    args = ["-k25", f"-b{max(20, genome.bit_length() + 7)}", fq]

    def p(name):
        return os.path.join(work, name)

    # the mesh runs come first: peak memory per device is cumulative,
    # and the one-card run would inflate device 0's
    t_mesh = run_cli(["--mesh", str(n_dev)] + args, p("mesh.out"),
                     p("mesh.log"))
    t_shard = run_cli(["--mesh", str(n_dev)] + args, p("shard.out"),
                      p("shard.log"), env={"BFC_SHARD_TABLE": "1"})
    peaks = [peak_bytes(i) for i in range(n_dev)]
    t_one = run_cli(args, p("one.out"), p("one.log"))
    assert_same(p("one.out"), p("mesh.out"), "phase 3 one card vs mesh")
    assert_same(p("one.out"), p("shard.out"), "phase 3 one card vs sharded")
    report(f"phase 3: {n} reads; one card {t_one:.2f}s, --mesh {n_dev} "
           f"{t_mesh:.2f}s, sharded table {t_shard:.2f}s (compile "
           f"included); outputs identical")
    report(f"phase 3 peak device bytes per device after the mesh runs: "
           f"{peaks}")
    if all(x is not None for x in peaks):
        if min(peaks) <= 0 or min(peaks) < 0.2 * max(peaks):
            raise AssertionError(f"phase 3: data not spread, peaks {peaks}")

    pfq = p("p3.profile.fq")
    bench.write_fastq(pfq, b, q, 0, min(profile_reads, n))
    tdir = p("trace")
    run_cli(["--mesh", str(n_dev), "--profile", tdir] + args[:-1] + [pfq],
            p("profile.out"), p("profile.log"))
    (a2a, n_a2a), (nccl, n_nccl), lines = collective_time(tdir)
    report(f"phase 3 trace ({min(profile_reads, n)} reads, --mesh {n_dev}): "
           f"{n_a2a} all-to-all op events, {a2a * 1e3:.3f} ms; {n_nccl} NCCL "
           f"kernel events, {nccl * 1e3:.3f} ms (summed over devices; device "
           f"trace lines {lines})")


def collective_time(trace_dir: str):
    """((seconds, events) of all-to-all ops, (seconds, events) of NCCL
    kernels, device line names) on the device planes of the newest
    profiler trace under trace_dir."""
    import glob

    import jax

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise RuntimeError(f"no profiler trace under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])
    a2a, nccl = [0, 0], [0, 0]
    lines = set()
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            lines.add(line.name)
            for ev in line.events:
                name = ev.name.lower().replace("_", "-")
                for acc, key in ((a2a, "all-to-all"), (nccl, "nccl")):
                    if key in name:
                        acc[0] += ev.duration_ns
                        acc[1] += 1
    return ((a2a[0] * 1e-9, a2a[1]), (nccl[0] * 1e-9, nccl[1]),
            sorted(lines))


# ---------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="run only phase 3, on four GPUs")
    ap.add_argument("--logdir",
                    help="keep the per-run outputs and logs here")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.stderr.write(f"chip_smoke: JAX found no GPU (platform "
                         f"{devs[0].platform}); this script runs on the card\n")
        return 1
    need = 4 if args.mesh4 else 1
    if len(devs) < need:
        sys.stderr.write(f"chip_smoke: needs {need} GPUs, found {len(devs)}\n")
        return 1
    global CARD
    CARD = card_line()
    print(CARD, flush=True)

    work = tempfile.mkdtemp(prefix="bfc_smoke_")
    t0 = time.time()
    try:
        phase0()
        if args.mesh4:
            phase3(work)
        else:
            phase1(work)
            phase2(work)
    finally:
        if args.logdir:
            os.makedirs(args.logdir, exist_ok=True)
            for f in os.listdir(work):
                if f.endswith(".log"):
                    shutil.copy(os.path.join(work, f), args.logdir)
        shutil.rmtree(work, ignore_errors=True)
    report(f"all phases passed in {time.time() - t0:.1f}s; peak device "
           f"bytes {peak_bytes()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
