"""Multi-host orchestration: one JAX process per host, one global mesh.

The reference scales within one shared-memory node (kthread.c worker
pools); the accelerator equivalent of "more cores" is more hosts, each
owning a slice of the cluster's devices (SURVEY.md §5.8).  This module wires
the existing mesh pipeline (parallel/mesh.py) across processes with
jax.distributed:

  init      every process calls jax.distributed.initialize and joins a
            single coordinator; the global mesh spans all hosts' devices
            (process-major order, so row-sharding by device equals
            row-sharding by host).
  input     every host scans the same FASTQ byte stream for record
            boundaries (offsets/lens - the cheap part), but DECODES and
            pads only the row stride its local devices own
            (fastx_parse_range + mesh.count_file_mesh; the reference's
            single reader thread never replicates work, bseq.c:52-76),
            then device_puts just that stride (mesh.gput).  Correction
            input keeps full decode on every host: difficulty bucketing
            permutes rows globally, so each host's device slice draws
            from arbitrary input rows.
  compute   unchanged: the sharded counting all_to_alls and the
            dp/sharded-table correction ride the same shard_map programs,
            now spanning hosts.
  output    per-batch result arrays are replicated by one device-level
            allgather (mesh.to_host, a collective every host must join),
            packed 4x smaller on device (correct_core's packed_bq
            plane); rank 0 ALONE assembles and emits records
            (BatchResult.emit) - host-side output work does not scale
            with host count - preserving the reference's ordered-output
            guarantee (kthread.c:92-101) by construction.

Launch modes:

  worker    env-driven: BFC_MH_COORD=host:port BFC_MH_NPROC=N
            BFC_MH_PID=i python -m bfc_jax.parallel.multihost <bfc args>
  launcher  N processes on one machine: on the CPU each gets --devices
            virtual devices (tests); on a GPU machine each gets --devices
            cards of its own (default 1) through CUDA_VISIBLE_DEVICES:
            python -m bfc_jax.parallel.multihost --launch 2 --devices 4 \
                -- --cpu -k19 reads.fq
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import List, Optional


def worker_main(argv: List[str]) -> int:
    """Run the CLI as one process of a multi-host job (env-configured)."""
    coord = os.environ.get("BFC_MH_COORD")
    nproc = int(os.environ.get("BFC_MH_NPROC", "1"))
    pid = int(os.environ.get("BFC_MH_PID", "0"))

    import jax

    if "--cpu" in argv:
        # the platform must be pinned before jax.distributed picks its
        # collectives backend (Gloo for CPU); the CLI's own --cpu switch
        # would come too late
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
    if nproc > 1:
        # Gloo (the CPU collectives backend) chatters on C-level fd 1;
        # divert fd 1 to stderr and keep a private handle to the real
        # stdout so the corrected-reads stream stays clean
        real_out = os.dup(1)
        os.dup2(2, 1)
        sys.stdout = os.fdopen(real_out, "w")
        assert coord, "BFC_MH_COORD must be set for multi-process runs"
        jax.distributed.initialize(
            coordinator_address=coord, num_processes=nproc, process_id=pid
        )
    n_dev = len(jax.devices())

    from .. import cli
    from ..utils import log as ulog

    if pid != 0:
        # every host computes identical output; only rank 0 emits it
        sys.stdout = open(os.devnull, "w")
        ulog.verbosity = 0
    if not any(a == "--mesh" or a.startswith("--mesh=") for a in argv):
        argv = ["--mesh", str(n_dev)] + argv
    return cli.main(argv)


def worker_env(base: dict, pid: int, nproc: int, port: int, cpu: bool,
               devices_per_host: Optional[int] = None) -> dict:
    """Environment of local worker `pid` of an nproc-process job.

    On the CPU each worker gets devices_per_host virtual devices.  On a
    GPU machine each worker gets devices_per_host (default 1) cards of
    its own through CUDA_VISIBLE_DEVICES, split from the caller's list
    when it set one: a JAX process reserves most of the memory of every
    card it sees, so workers sharing cards would fail for want of it.
    Raises ValueError when the caller's list has too few cards."""
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(base)
    env["BFC_MH_COORD"] = f"127.0.0.1:{port}"
    env["BFC_MH_NPROC"] = str(nproc)
    env["BFC_MH_PID"] = str(pid)
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    if cpu:
        if devices_per_host:
            import re

            flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                           env.get("XLA_FLAGS", ""))
            env["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={devices_per_host}"
            ).strip()
        return env
    per = devices_per_host or 1
    visible = base.get("CUDA_VISIBLE_DEVICES")
    cards = ([c.strip() for c in visible.split(",") if c.strip()]
             if visible is not None else [str(i) for i in range(nproc * per)])
    if len(cards) < nproc * per:
        raise ValueError(
            f"{nproc} processes x {per} cards need {nproc * per} cards; "
            f"CUDA_VISIBLE_DEVICES lists {len(cards)}")
    env["CUDA_VISIBLE_DEVICES"] = ",".join(cards[pid * per:(pid + 1) * per])
    return env


def launch(nproc: int, argv: List[str], devices_per_host: Optional[int] = None,
           stdout=None) -> int:
    """Spawn an nproc-process job on this machine, one process per card
    (see worker_env).  Rank 0's stdout passes through (or into
    `stdout`); returns max rc."""
    cpu = ("--cpu" in argv
           or os.environ.get("JAX_PLATFORMS", "").split(",")[0] == "cpu")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    envs = [worker_env(os.environ, pid, nproc, port, cpu, devices_per_host)
            for pid in range(nproc)]
    procs = []
    for pid, env in enumerate(envs):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "bfc_jax.parallel.multihost"] + list(argv),
            env=env,
            stdout=(stdout if pid == 0 else subprocess.DEVNULL),
        ))
    import time

    try:
        # poll instead of serial wait(): a dead peer leaves survivors
        # blocked inside a collective forever, and a serial wait would
        # never reach the cleanup that kills them
        rcs = [None] * nproc
        deadline = None
        while True:
            for i, p in enumerate(procs):
                if rcs[i] is None:
                    rcs[i] = p.poll()
            if all(rc is not None for rc in rcs):
                return max(rcs)
            if any(rc not in (None, 0) for rc in rcs):
                # a worker failed; give the rest a grace period to exit
                if deadline is None:
                    deadline = time.time() + 30
                elif time.time() > deadline:
                    return max(rc for rc in rcs if rc is not None)
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def _main(argv: List[str]) -> int:
    if argv[:1] == ["--launch"]:
        nproc = int(argv[1])
        rest = argv[2:]
        devices = None
        if rest[:1] == ["--devices"]:
            devices = int(rest[1])
            rest = rest[2:]
        if rest[:1] == ["--"]:
            rest = rest[1:]
        return launch(nproc, rest, devices_per_host=devices)
    return worker_main(argv)


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))


def gather_segments(seg: bytes):
    """All-to-rank-0 exchange of per-host formatted byte segments.

    Every host calls this with its window slice's bytes (a collective:
    all ranks must participate).  Returns the segments in host order on
    rank 0 and [] elsewhere.  Two process_allgathers: exact lengths,
    then the payload padded to the global max (device collectives are
    fixed-shape)."""
    import jax
    import numpy as np
    from jax.experimental import multihost_utils as mhu

    H = jax.process_count()
    if H == 1:
        return [seg]
    n = np.array([len(seg)], np.int64)
    lens = np.asarray(mhu.process_allgather(n)).reshape(-1)
    m = max(int(lens.max()), 1)
    pad = np.zeros((m,), np.uint8)
    pad[: len(seg)] = np.frombuffer(seg, np.uint8)
    allb = np.asarray(mhu.process_allgather(pad))
    if jax.process_index() != 0:
        return []
    allb = allb.reshape(H, m)
    return [allb[h, : int(lens[h])].tobytes() for h in range(H)]
