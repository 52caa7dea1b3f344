"""Drop-in compatible CLI (reference surface: /root/reference/bfc.c:55-158).

Usage: bfc-jax [options] <to-count.fq> [to-correct.fq]

Same flags and stdout contract as the reference `bfc`; extra device
options are long options that do not collide with the reference's getopt
string.
"""

from __future__ import annotations

import getopt
import sys
from typing import List, Optional

from . import __version__
from .opts import Opts
from .utils import log as ulog

VERSION = f"jax-{__version__}(r181-compat)"


def usage(fp, o: Opts) -> None:
    fp.write("Usage: bfc-jax [options] <to-count.fq> [to-correct.fq]\n")
    fp.write("Options:\n")
    fp.write("  -s FLOAT     approx genome size (k/m/g allowed; change -k and -b) [unset]\n")
    fp.write(f"  -k INT       k-mer length [{o.k}]\n")
    fp.write(f"  -t INT       number of threads (I/O only; compute is batched) [{o.n_threads}]\n")
    fp.write(f"  -b INT       set Bloom filter size to pow(2,INT) bits [{o.bf_shift}]\n")
    fp.write(f"  -H INT       use INT hash functions for Bloom filter [{o.n_hashes}]\n")
    fp.write("  -d FILE      dump hash table to FILE [null]\n")
    fp.write("  -E           skip error correction\n")
    fp.write("  -R           refine bfc-corrected reads\n")
    fp.write("  -r FILE      restore hash table from FILE [null]\n")
    fp.write(f"  -w INT       no more than 5 ec or 2 highQ ec in INT-bp window [{o.win_multi_ec}]\n")
    fp.write(f"  -c INT       min k-mer coverage [{o.min_cov}]\n")
    fp.write("  -Q           force FASTA output\n")
    fp.write("  -1           drop reads containing unique k-mers\n")
    fp.write("  -v           show version number\n")
    fp.write("  -h           show command line help\n")
    fp.write("Device options:\n")
    fp.write("  --batch INT     reads per device correction batch [8192]\n")
    fp.write("  --cpu           run on the host CPU backend\n")
    fp.write("  --scalar        use the scalar reference model (debug)\n")
    fp.write("  --mesh INT      shard counting over INT devices; dp correction\n")
    fp.write("  --profile DIR   write a JAX profiler trace of the run to DIR\n")


def parse_size(s: str) -> int:
    """strtod-style size parse: leading float, then only the FIRST char of
    the remainder selects the multiplier (bfc.c:112-121; accepts e.g.
    `3gb`, `4.5Mbp` exactly like the reference)."""
    import re

    m = re.match(r"\s*[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?", s)
    x = float(m.group(0)) if m else 0.0
    rest = s[m.end():] if m else s
    if rest[:1] in ("g", "G"):
        x *= 1e9
    elif rest[:1] in ("m", "M"):
        x *= 1e6
    elif rest[:1] in ("k", "K"):
        x *= 1e3
    return int(x) + 1


def _select_device(use_cpu: bool) -> bool:
    """Pin the backend and log it; False when JAX found no accelerator
    and the caller did not ask for the CPU (--cpu or JAX_PLATFORMS=cpu),
    so that a missing GPU never turns into a silent CPU run."""
    import os

    import jax

    if use_cpu:
        jax.config.update("jax_platforms", "cpu")
        from .utils.cache import apply_cache_dir

        apply_cache_dir("cpu")
    elif (jax.default_backend() == "cpu"
          and os.environ.get("JAX_PLATFORMS", "").split(",")[0] != "cpu"):
        sys.stderr.write("bfc-jax: JAX found no GPU (its default backend is "
                         "cpu); pass --cpu to run on the host CPU\n")
        return False
    devs = jax.devices()
    sys.stderr.write(f"[M::main] device: {devs[0].platform} "
                     f"{devs[0].device_kind} x{len(devs)}\n")
    return True


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opt = Opts()
    in_hash = out_hash = None
    no_ec = False
    batch_reads = 8192
    use_cpu = False
    use_scalar = False
    mesh_devices = 0
    profile_dir = None
    ulog.reset_clock()
    try:
        optlist, args = getopt.getopt(
            argv, "hvV:Ed:k:s:b:L:t:C:H:q:Jr:c:w:D1QR",
            ["batch=", "cpu", "scalar", "mesh=", "profile="],
        )
    except getopt.GetoptError as e:
        sys.stderr.write(f"bfc-jax: {e}\n")
        usage(sys.stderr, opt)
        return 1
    for flag, val in optlist:
        if flag == "-d":
            out_hash = val
        elif flag == "-r":
            in_hash = val
        elif flag == "-q":
            opt.q = int(val)
        elif flag == "-b":
            opt.bf_shift = int(val)
        elif flag == "-t":
            opt.n_threads = int(val)
        elif flag == "-H":
            opt.n_hashes = int(val)
        elif flag == "-c":
            opt.min_cov = int(val)
        elif flag == "-w":
            opt.win_multi_ec = int(val)
        elif flag == "-R":
            opt.refine_ec = True
        elif flag == "-D":
            opt.discard = True
        elif flag == "-1":
            opt.filter_mode = True
        elif flag == "-Q":
            opt.no_qual = True
        elif flag == "-J":
            opt.no_mt_io = True
        elif flag == "-E":
            no_ec = True
        elif flag == "-V":
            opt.verbose = int(val)
            ulog.verbosity = opt.verbose
        elif flag == "-k":
            opt.k = int(val)
            sys.stderr.write(f"[M::main] set k to {opt.k}\n")
        elif flag == "-h":
            usage(sys.stdout, opt)
            return 0
        elif flag == "-v":
            print(VERSION)
            return 0
        elif flag == "-s":
            opt.apply_genome_size(parse_size(val))
            sys.stderr.write(f"[M::main] applied `-k {opt.k} -b {opt.bf_shift}'\n")
        elif flag == "-L":
            opt.chunk_size = parse_size(val)
        elif flag == "--batch":
            batch_reads = int(val)
        elif flag == "--cpu":
            use_cpu = True
        elif flag == "--scalar":
            use_scalar = True
        elif flag == "--mesh":
            mesh_devices = int(val)
        elif flag == "--profile":
            profile_dir = val
    if not args:
        usage(sys.stderr, opt)
        return 1

    if opt.verbose >= 4 and not use_scalar:
        # the per-read search trace (correct.c:284-287 etc.) exists only in
        # the scalar engine; output is byte-identical either way, so -V4
        # routes through it to reproduce the reference's debugging hook
        sys.stderr.write("[M::main] -V4 search trace: using the scalar engine\n")
        use_scalar = True

    count_fn = args[0]
    correct_fn = args[1] if len(args) > 1 else None
    if use_scalar:
        from .models import pipeline as P
        from .models import refmodel as _rm

        _rm.verbose = opt.verbose

        out = P.run(opt, count_fn, correct_fn=correct_fn, in_hash=in_hash,
                    out_hash=out_hash, no_ec=no_ec)
        sys.stdout.write(out)
    else:
        if not _select_device(use_cpu):
            return 1
        from .models import device_pipeline as DP

        if profile_dir:
            import jax

            jax.profiler.start_trace(profile_dir)
        # stream records to stdout as batches finish (O(batch) memory,
        # the reference's pipeline behavior)
        DP.run_device(opt, count_fn, correct_fn=correct_fn, in_hash=in_hash,
                      out_hash=out_hash, no_ec=no_ec, batch_reads=batch_reads,
                      mesh_devices=mesh_devices, sink=sys.stdout.buffer)
        if profile_dir:
            import jax

            jax.profiler.stop_trace()
            sys.stderr.write(f"[M::main] profiler trace written to {profile_dir}\n")
    sys.stderr.write(f"[M::main] Version: {VERSION}\n")
    sys.stderr.write("[M::main] CMD: bfc-jax " + " ".join(argv) + "\n")
    sys.stderr.write(
        f"[M::main] Real time: {ulog.realtime():.3f} sec; CPU: {ulog.cputime():.3f} sec\n"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
