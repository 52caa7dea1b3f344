"""Byte-equality of the scalar model against the compiled reference bfc.

These are the ground-truth semantic tests: the model's FASTQ output must
match `bfc -t1` exactly, and its spectrum must match the reference dump
(canonicalized through the reference's own hash2cnt decoder).
"""

import subprocess

import pytest

from bfc_jax.models import pipeline as P
from bfc_jax.models import refmodel as M
from bfc_jax.opts import Opts

from . import datagen, oracle


@pytest.fixture(scope="module")
def small_dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    path = datagen.standard_dataset(str(d), genome_len=20000, n_reads=6000)
    return str(d), path


def canon_table(ch: M.CountHash):
    """Render the model table as {kmer_string: (count, high)} via hash inversion."""
    out = {}
    k, l_pre = ch.k, ch.l_pre
    for shard, ident, payload in ch.items():
        # reverse of ch_shard_key (htab.c:45-58), valid when no truncation
        if k <= 32:
            z = (shard << (2 * k - l_pre)) | ident
            h0, h1 = z >> k, z & ((1 << k) - 1)
        else:
            t = k - l_pre
            mask_k = (1 << k) - 1
            h1 = ident & mask_k
            x0_low = ident >> k
            h0 = (shard << t) | x0_low
        y0, y1 = M.kmer_hash_inv(k, h0, h1)
        out[M.kmer_2str(k, y0, y1)] = (payload & 0xFF, (payload >> 8) & 0x3F)
    return out


def parse_hash2cnt(text: bytes):
    out = {}
    for line in text.decode().splitlines():
        parts = line.split()
        if len(parts) == 3:
            out[parts[0]] = (int(parts[1]), int(parts[2]))
    return out


@pytest.mark.slow
def test_count_table_matches_reference(small_dataset, tmp_path):
    d, fq = small_dataset
    opt = Opts()
    opt.apply_genome_size(20000)  # -s 20k: k=15 ... small genome
    dump = tmp_path / "ref.hash"
    _, err = oracle.run_bfc(["-s", "20k", "-t1", "-E", "-d", str(dump), fq])
    ref_tab = parse_hash2cnt(oracle.run_hash2cnt(dump))
    _, ch = P.count_file(fq, opt)
    mine = canon_table(ch)
    assert len(mine) == len(ref_tab)
    assert mine == ref_tab


@pytest.mark.slow
def test_correct_output_matches_reference(small_dataset):
    d, fq = small_dataset
    opt = Opts()
    opt.apply_genome_size(20000)
    ref_out, _ = oracle.run_bfc(["-s", "20k", "-t1", fq])
    mine = P.run(opt, fq)
    assert mine.encode() == ref_out


@pytest.mark.slow
def test_trim_output_matches_reference(small_dataset):
    d, fq = small_dataset
    opt = Opts()
    opt.apply_genome_size(20000)
    opt.filter_mode = True
    ref_out, _ = oracle.run_bfc(["-s", "20k", "-t1", "-1", fq])
    mine = P.run(opt, fq)
    assert mine.encode() == ref_out
