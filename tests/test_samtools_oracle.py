"""Independent per-site depth oracle cross-check (SURVEY.md §4.5).

The reference's accuracy claim is "completely consistent with
samtools depth (version >=1.10)" (/root/reference/README.md:147). The
rest of the suite proves byte parity against the reference binary;
this file closes the loop against an oracle whose counting machinery
shares NOTHING with PanDepth's CIGAR loops or with pandepth_jax's
event sweeps:

- real ``samtools depth -aa`` whenever a samtools binary is available
  (``SAMTOOLS`` env var or PATH);
- otherwise ``tests/htsdepth_oracle.c`` — a small C tool built on
  demand against the reference tree's prebuilt htslib
  (/root/reference/lib/libhts.a) that derives depth from htslib's own
  PILEUP engine (bam_plp) with samtools-depth semantics (``-aa``
  zero-fill, flag mask, ``-Q`` mapq filter). This image ships no
  samtools and has no egress, so the htsdepth path is what actually
  executes here — the oracle tests run in the default suite instead
  of perpetually skipping.

Comparison: our ``-a`` SiteDepth dump (0-based, all positions of every
regioned contig — in chr mode that is every contig) against the
oracle's 1-based all-position rows. Default flag masks agree (both
skip UNMAP|SECONDARY|QCFAIL|DUP=1796); mapq filters map
``pandepth -q N`` == ``samtools depth -Q N`` == ``htsdepth bam N``.
Fixtures use ``end_slack=0``: reads overhanging a contig end pile up
past the header length in a pileup oracle while both pandepth
implementations clamp to the contig (reference slack-cell behavior).
"""

import gzip
import os
import shutil
import subprocess

import pytest

HTSDEPTH_SRC = os.path.join(os.path.dirname(__file__),
                            "htsdepth_oracle.c")
HTSDEPTH_BIN = "/tmp/refbin/htsdepth"
REF_LIB = "/root/reference/lib"


def _samtools():
    exe = os.environ.get("SAMTOOLS") or shutil.which("samtools")
    if not exe:
        return None
    try:
        out = subprocess.run([exe, "--version"], capture_output=True,
                             text=True, timeout=30)
        if out.returncode != 0:
            return None
    except (OSError, subprocess.TimeoutExpired):
        return None
    return exe


def _htsdepth():
    """Build (once) and return the htsdepth oracle, or None when the
    reference tree's htslib isn't present."""
    if os.path.exists(HTSDEPTH_BIN):
        return HTSDEPTH_BIN
    if not os.path.isdir(REF_LIB):
        return None
    os.makedirs(os.path.dirname(HTSDEPTH_BIN), exist_ok=True)
    try:
        subprocess.run(
            ["gcc", "-O2", "-o", HTSDEPTH_BIN, HTSDEPTH_SRC,
             "-I/root/reference/include", f"-L{REF_LIB}",
             "-lhts", "-ldeflate", "-lz", "-lpthread", "-lm"],
            check=True, capture_output=True, timeout=300)
        return HTSDEPTH_BIN
    except Exception:
        return None


SAMTOOLS = _samtools()
ORACLE = SAMTOOLS or _htsdepth()

pytestmark = pytest.mark.skipif(
    ORACLE is None,
    reason="no depth oracle (no samtools and no /root/reference/lib "
           "to build htsdepth against)")


def _our_sites(tmp_path, bam, extra=()):
    from pandepth_jax.cli import main as cli_main

    prefix = str(tmp_path / "ours")
    rc = cli_main(["pandepth", "-i", bam, "-a", "-o", prefix]
                  + list(extra))
    assert rc == 0
    lines = []
    with gzip.open(prefix + ".SiteDepth.gz", "rt") as fh:
        for ln in fh:
            chrom, pos0, dep = ln.rstrip("\n").split("\t")
            lines.append(f"{chrom}\t{int(pos0) + 1}\t{dep}")
    return lines


def _oracle_sites(bam, min_mapq=None):
    if SAMTOOLS:
        extra = ["-Q", str(min_mapq)] if min_mapq is not None else []
        out = subprocess.run([SAMTOOLS, "depth", "-aa", *extra, bam],
                             capture_output=True, text=True,
                             timeout=300)
    else:
        argv = [ORACLE, bam]
        if min_mapq is not None:
            argv.append(str(min_mapq))
        out = subprocess.run(argv, capture_output=True, text=True,
                             timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return [ln for ln in out.stdout.splitlines() if ln]


@pytest.mark.parametrize("seed", [71, 72])
def test_site_depth_matches_oracle(tmp_path, seed):
    from tests.fixtures import make_bam

    bam = str(tmp_path / "in.bam")
    make_bam(bam, n=600, seed=seed, end_slack=0)
    ours = _our_sites(tmp_path, bam)
    theirs = _oracle_sites(bam)
    assert ours == theirs


def test_site_depth_matches_oracle_mapq(tmp_path):
    from tests.fixtures import make_bam

    bam = str(tmp_path / "in.bam")
    make_bam(bam, n=600, seed=73, end_slack=0)
    ours = _our_sites(tmp_path, bam, extra=["-q", "30"])
    theirs = _oracle_sites(bam, min_mapq=30)
    assert ours == theirs
