"""chip_smoke.py's phases and guards, rehearsed on the CPU at a tiny size."""

import chip_smoke


def test_phase1_parity_tiny(tmp_path):
    """Phase 1 at a tiny size: every mode's device output equals the
    scalar model's, and the forced-spill run really spills."""
    chip_smoke.phase1(str(tmp_path), genome=6000, n_reads=800,
                      spill_chunk="20k", spill_cap=1 << 12)


def test_main_refuses_without_gpu(capsys):
    """On a machine without a GPU the script fails and prints no result."""
    assert chip_smoke.main([]) == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert "no GPU" in err
