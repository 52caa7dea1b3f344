"""Option-matrix parity: non-default -c/-w/-q/-H combinations."""

import pytest

from bfc_jax.models import device_pipeline as DP
from bfc_jax.opts import Opts

from . import datagen, oracle


@pytest.fixture(scope="module")
def fq(tmp_path_factory):
    d = tmp_path_factory.mktemp("optmat")
    return datagen.standard_dataset(str(d), genome_len=9000, n_reads=2500,
                                    read_len=100)


CASES = [
    # (cli args, opt updates)
    (["-c", "4"], dict(min_cov=4)),
    (["-c", "2"], dict(min_cov=2)),
    (["-w", "15"], dict(win_multi_ec=15)),
    (["-w", "3"], dict(win_multi_ec=3)),
    (["-q", "30"], dict(q=30)),
    (["-q", "10"], dict(q=10)),
    (["-H", "3"], dict(n_hashes=3)),
    (["-H", "6"], dict(n_hashes=6)),
    (["-c", "5", "-q", "25", "-w", "8"], dict(min_cov=5, q=25, win_multi_ec=8)),
]


@pytest.mark.slow
@pytest.mark.parametrize("args,updates", CASES,
                         ids=["_".join(c[0]).replace("-", "") for c in CASES])
def test_option_parity(fq, args, updates):
    ref_out, _ = oracle.run_bfc(["-k19", "-b23", "-t1"] + args + [fq])
    opt = Opts()
    opt.k = 19
    opt.bf_shift = 23
    for kk, v in updates.items():
        setattr(opt, kk, v)
    mine = DP.run_device(opt, fq, batch_reads=1024)
    assert mine.encode() == ref_out
