"""errstat tool: SAM parsing and better/worse accounting."""

import subprocess
import sys

SAM1 = """@SQ\tSN:ref\tLN:10000
r1\t0\tref\t100\t60\t100M\t*\t0\t0\t*\t*\tNM:i:0
r2\t0\tref\t200\t60\t90M10S\t*\t0\t0\t*\t*\tNM:i:2
r3\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*
r4\t0\tref\t300\t60\t50M\t*\t0\t0\t*\t*\tNM:i:1
r4\t2048\tref\t900\t60\t50M\t*\t0\t0\t*\t*\tNM:i:0
"""

SAM2 = """@SQ\tSN:ref\tLN:10000
r1\t0\tref\t100\t60\t100M\t*\t0\t0\t*\t*\tNM:i:1
r2\t0\tref\t200\t60\t90M10S\t*\t0\t0\t*\t*\tNM:i:0
r3\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*
r4\t0\tref\t300\t60\t50M\t*\t0\t0\t*\t*\tNM:i:1
r4\t2048\tref\t900\t60\t50M\t*\t0\t0\t*\t*\tNM:i:0
"""


def run_errstat(tmp_path, *files):
    paths = []
    for i, content in enumerate(files):
        p = tmp_path / f"f{i}.sam"
        p.write_text(content)
        paths.append(str(p))
    r = subprocess.run(
        [sys.executable, "-m", "bfc_jax.tools.errstat"] + paths,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_single_file_stats(tmp_path):
    out = run_errstat(tmp_path, SAM1)
    assert "# reads:             4" in out
    assert "# perfect reads:     1" in out
    assert "# unmapped reads:    1" in out
    assert "# chimeric reads:    1" in out
    assert "# chimeric events:   1" in out
    assert "# reads w/ base err: 2" in out
    assert "# error bases:       3" in out
    assert "# clipped reads:     1" in out
    assert "# clipped bases:     10" in out


def test_two_file_better_worse(tmp_path):
    out = run_errstat(tmp_path, SAM1, SAM2)
    # r1: file1 match 100 > file2 99 -> better; r2: 88 < 90 -> worse
    assert "# better reads:      1" in out
    assert "# worse reads:       1" in out
    lines = [l for l in out.splitlines() if l and l[0] in "12"]
    assert lines[0].startswith("1 r1/0 100")
    assert lines[1].startswith("2 r2/0 88")
