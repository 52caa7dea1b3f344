"""2-process multi-host job (jax.distributed, CPU simulation) vs the reference.

Spawns two coordinated worker processes, each with 4 virtual CPU
devices, forming one 8-device global mesh; sharded counting and dp
correction span both processes and rank 0 writes the output.  The
contract is the usual one: byte-identical to `bfc -t1`."""

import pytest

from bfc_jax.parallel import multihost

from . import datagen, oracle


@pytest.mark.parametrize("cpu,per,visible,pid,want", [
    (True, 4, None, 1, None),
    (False, None, None, 1, "1"),
    (False, 2, None, 1, "2,3"),
    (False, 1, "5,7", 1, "7"),
], ids=["cpu-virtual", "gpu-one-each", "gpu-two-each", "gpu-caller-list"])
def test_worker_env_gives_each_process_its_cards(cpu, per, visible, pid,
                                                 want):
    """A local N-process job never shares a card between workers: each
    gets its own slice of CUDA_VISIBLE_DEVICES (or CPU virtual devices)."""
    base = {"PATH": "/bin"}
    if visible is not None:
        base["CUDA_VISIBLE_DEVICES"] = visible
    env = multihost.worker_env(base, pid, 2, 1234, cpu, per)
    assert env["BFC_MH_PID"] == str(pid) and env["BFC_MH_NPROC"] == "2"
    assert env.get("CUDA_VISIBLE_DEVICES", None) == (
        want if not cpu else visible)
    if cpu:
        assert "--xla_force_host_platform_device_count=4" in env["XLA_FLAGS"]


def test_worker_env_refuses_too_few_cards():
    with pytest.raises(ValueError, match="need 4 cards"):
        multihost.worker_env({"CUDA_VISIBLE_DEVICES": "0,1,2"}, 0, 2, 1234,
                             False, 2)


@pytest.mark.slow
def test_multihost_matches_reference(tmp_path):
    fq = datagen.standard_dataset(
        str(tmp_path), genome_len=6000, n_reads=1600, name="mh.fq"
    )
    ref_out, _ = oracle.run_bfc(["-k17", "-b22", "-t1", fq])
    out_path = tmp_path / "mh_out.fq"
    with open(out_path, "wb") as fo:
        rc = multihost.launch(
            2, ["--cpu", "--batch", "512", "-k17", "-b22", fq],
            devices_per_host=4, stdout=fo,
        )
    assert rc == 0
    assert out_path.read_bytes() == ref_out


@pytest.mark.slow
def test_multihost_sharded_table(tmp_path):
    """Same job with the spectrum sharded (not replicated) across the
    two processes' devices: correction lookups route over the mesh."""
    import os

    fq = datagen.standard_dataset(
        str(tmp_path), genome_len=6000, n_reads=1600, name="mhs.fq"
    )
    ref_out, _ = oracle.run_bfc(["-k17", "-b22", "-t1", fq])
    out_path = tmp_path / "mhs_out.fq"
    os.environ["BFC_SHARD_TABLE"] = "1"
    try:
        with open(out_path, "wb") as fo:
            rc = multihost.launch(
                2, ["--cpu", "--batch", "512", "-k17", "-b22", fq],
                devices_per_host=4, stdout=fo,
            )
    finally:
        del os.environ["BFC_SHARD_TABLE"]
    assert rc == 0
    assert out_path.read_bytes() == ref_out
