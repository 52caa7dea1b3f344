"""Full mesh pipeline (sharded counting + dp correction) vs the reference."""

import jax
import pytest

from bfc_jax.models import device_pipeline as DP
from bfc_jax.opts import Opts

from . import datagen, oracle


@pytest.mark.slow
def test_mesh_pipeline_matches_reference(tmp_path):
    assert len(jax.devices()) >= 8
    fq = datagen.standard_dataset(
        str(tmp_path), genome_len=8000, n_reads=2400, name="m.fq"
    )
    ref_out, _ = oracle.run_bfc(["-k17", "-b22", "-t1", fq])
    opt = Opts()
    opt.k = 17
    opt.bf_shift = 22
    mine = DP.run_device(opt, fq, mesh_devices=8, batch_reads=1024)
    assert mine.encode() == ref_out


@pytest.mark.slow
def test_mesh_pipeline_lsm_spill(tmp_path, monkeypatch):
    """Same contract with the device merge cap forced tiny: the mesh
    counting binary counter LSM-spills every few batches and finalizes
    from the host tree (the human-scale capacity path)."""
    assert len(jax.devices()) >= 8
    monkeypatch.setenv("BFC_MAX_MERGE_CAP", str(1 << 14))
    fq = datagen.standard_dataset(
        str(tmp_path), genome_len=8000, n_reads=2400, name="ms.fq"
    )
    ref_out, _ = oracle.run_bfc(["-k17", "-b22", "-t1", fq])
    opt = Opts()
    opt.k = 17
    opt.bf_shift = 22
    mine = DP.run_device(opt, fq, mesh_devices=8, batch_reads=1024)
    assert mine.encode() == ref_out
