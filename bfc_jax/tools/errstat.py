"""Correction-quality scoring from SAM alignments.

Python equivalent of the reference evaluation harness
(/root/reference/errstat.js): groups SAM lines by read segment
(name + read1/read2 flag), accumulates NM / clipping / chimeric-segment
stats, and in two-file mode reports per-read better/worse counts - the
measurement behind the paper's Perfect/Better/Worse columns.

Usage: python -m bfc_jax.tools.errstat ec1.sam [ec2.sam [skip_missing]]
"""

from __future__ import annotations

import re
import sys
from typing import Iterator, Optional

_CIGAR = re.compile(r"(\d+)([MIDNSH])")


class SegStat:
    __slots__ = ("name", "n_segs", "nm", "cliplen", "match")

    def __init__(self):
        self.name = ""
        self.n_segs = 0
        self.nm = 0
        self.cliplen = 0
        self.match = 0


def _sam_records(fp) -> Iterator[list]:
    for line in fp:
        if line.startswith("@"):
            continue
        t = line.rstrip("\n").split("\t")
        t[1] = int(t[1])
        yield t


class SegReader:
    """Yields one SegStat per read segment (grouping consecutive lines)."""

    def __init__(self, fp):
        self._it = _sam_records(fp)
        self._pending: Optional[list] = None

    def read1(self) -> Optional[SegStat]:
        t = self._pending
        if t is None:
            t = next(self._it, None)
            if t is None:
                return None
        name = f"{t[0]}/{(t[1] >> 6) & 3}"
        lines = [t]
        self._pending = None
        for t in self._it:
            s = f"{t[0]}/{(t[1] >> 6) & 3}"
            if s != name:
                self._pending = t
                break
            lines.append(t)
        st = SegStat()
        st.name = name
        t = lines[0]
        n_indels = n_matches = 0
        if (t[1] & 4) == 0:
            for m in _CIGAR.finditer(t[5]):
                ln = int(m.group(1))
                op = m.group(2)
                if op in "SH":
                    st.cliplen += ln
                elif op in "ID":
                    n_indels += ln
                elif op == "M":
                    n_matches += ln
        for i, t in enumerate(lines):
            if t[1] & 4:
                continue
            for fld in t[11:]:
                if fld.startswith("NM:i:"):
                    st.nm += int(fld[5:])
            st.n_segs += 1
            if i == 0:
                st.match = n_matches - (st.nm - n_indels)
        return st


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    f1 = open(argv[0]) if argv else sys.stdin
    f2 = open(argv[1]) if len(argv) >= 2 else None
    skip_missing = len(argv) >= 3
    r1 = SegReader(f1)
    r2 = SegReader(f2) if f2 else None

    n_err_bases = n_err_reads = tot_reads = n_chimeric = 0
    n_chimeric_reads = n_unmapped = n_perfect = n_clipped = tot_clip = 0
    n1 = n2 = 0
    while True:
        st1 = r1.read1()
        if st1 is None:
            break
        tot_reads += 1
        tot_clip += st1.cliplen
        if st1.nm == 0 and st1.cliplen == 0 and st1.n_segs == 1:
            n_perfect += 1
        if st1.nm > 0:
            n_err_reads += 1
            n_err_bases += st1.nm
        if st1.cliplen != 0:
            n_clipped += 1
        if st1.n_segs == 0:
            n_unmapped += 1
        elif st1.n_segs > 1:
            n_chimeric_reads += 1
            n_chimeric += st1.n_segs - 1
        if r2:
            st2 = r2.read1()
            if st2 is None:
                raise RuntimeError("the 2nd file has fewer reads")
            if skip_missing and st1.name != st2.name:
                while st2 is not None and st2.name != st1.name:
                    st2 = r2.read1()
                if st2 is None:
                    raise RuntimeError("read not found in 2nd file")
            if st1.match != st2.match:
                tag = "1" if st1.match > st2.match else "2"
                if tag == "1":
                    n1 += 1
                else:
                    n2 += 1
                print(tag, st1.name, st1.match, st1.n_segs, st1.cliplen, st1.nm,
                      st2.match, st2.n_segs, st2.cliplen, st2.nm)

    print("# reads:             %d" % tot_reads)
    print("# perfect reads:     %d" % n_perfect)
    print("# unmapped reads:    %d" % n_unmapped)
    print("# chimeric reads:    %d" % n_chimeric_reads)
    print("# chimeric events:   %d" % n_chimeric)
    print("# reads w/ base err: %d" % n_err_reads)
    print("# error bases:       %d" % n_err_bases)
    print("# clipped reads:     %d" % n_clipped)
    print("# clipped bases:     %d" % tot_clip)
    if r2:
        print("# better reads:      %d" % n1)
        print("# worse reads:       %d" % n2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
