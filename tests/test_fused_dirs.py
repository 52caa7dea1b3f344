"""Fused-direction search (one [2B]-lane lockstep loop) vs the
two-sequential-loops form: byte-identical outputs.

The fused form (SearchConfig.fused_dirs, default on) runs the forward
and reverse-complement passes of bfc_ec1 (/root/reference/correct.c:
425-431) as a single batched loop; direction-2 results for lanes whose
forward pass failed are discarded, so the outputs must match the gated
sequential form bit for bit.
"""

import dataclasses

import numpy as np

from bfc_jax.models import corrector as DC
from bfc_jax.models import counter as C
from bfc_jax.opts import Opts

from . import datagen


def test_fused_equals_sequential():
    genome = datagen.make_genome(8000, seed=51)
    reads = datagen.simulate_reads(genome, 2000, read_len=100,
                                   err_rate=0.02, seed=52)
    # inject some Ns to hit the greedy/no-solid paths in both modes
    import random

    rng = random.Random(53)
    mod = []
    for seq, qual in reads[:300]:
        s = list(seq)
        for _ in range(rng.randrange(0, 4)):
            s[rng.randrange(len(s))] = "N"
        mod.append(("".join(s), qual))
    opt = Opts()
    opt.k = 19
    opt.bf_shift = 23
    ds = C.count_stream(iter(reads), opt, batch_reads=1024)

    corr_f = DC.Corrector(opt, ds)
    corr_s = DC.Corrector(opt, ds)
    corr_f.cfg = corr_f.cfg._replace(fused_dirs=True)
    corr_f.cfg_main = corr_f.cfg_main._replace(fused_dirs=True)
    corr_s.cfg = corr_s.cfg._replace(fused_dirs=False)
    corr_s.cfg_main = corr_s.cfg_main._replace(fused_dirs=False)

    seqs = [r[0] for r in mod]
    quals = [r[1] for r in mod]
    got_f = corr_f.correct_batch(seqs, quals)
    got_s = corr_s.correct_batch(seqs, quals)
    for i, ((stf, sf, qf), (sts, ss, qs)) in enumerate(zip(got_f, got_s)):
        assert dataclasses.astuple(stf) == dataclasses.astuple(sts), i
        assert sf == ss, i
        assert qf == qs, i
