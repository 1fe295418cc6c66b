"""Golden-file parity that does not need the reference binary: the
oracle outputs for the five BASELINE.md configs are committed under
tests/golden/ (generated once by the reference binary on the fixed
fixtures; regenerate with `python tests/test_golden.py`)."""

import glob
import os
import sys

import pytest

from tests.fixtures import (gunzip_bytes, make_bam, make_bed, make_fasta,
                            make_gff)

from pandepth_jax.cli import main as cli_main

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

CONFIGS = {
    "chr": [],
    "win": ["-w", "100"],
    "bed": ["-b", "{bed}"],
    "gene": ["-g", "{gff}", "-f", "CDS"],
    "gene_gc": ["-g", "{gff_safe}", "-c", "-r", "{fa}"],
}


def _make_fixtures(tmp: str) -> dict:
    paths = {
        "bam": os.path.join(tmp, "t.bam"),
        "bed": os.path.join(tmp, "t.bed"),
        "gff": os.path.join(tmp, "t.gff"),
        "gff_safe": os.path.join(tmp, "safe.gff"),
        "fa": os.path.join(tmp, "ref.fa"),
    }
    make_bam(paths["bam"], n=800, seed=11)
    make_bed(paths["bed"])
    make_gff(paths["gff"])
    make_gff(paths["gff_safe"], overhang=False)
    make_fasta(paths["fa"])
    return paths


def _run(tmp: str, name: str, args, paths) -> str:
    out = os.path.join(tmp, f"out_{name}")
    real_args = [a.format(**paths) for a in args]
    rc = cli_main(["pandepth", "-i", paths["bam"], "-o", out]
                  + real_args)
    assert rc == 0
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden(tmp_path, name):
    tmp = str(tmp_path)
    paths = _make_fixtures(tmp)
    out = _run(tmp, name, CONFIGS[name], paths)
    produced = sorted(glob.glob(out + "*.gz"))
    assert produced
    for p in produced:
        suffix = os.path.basename(p)[len(f"out_{name}"):]
        golden = os.path.join(GOLDEN_DIR, name + suffix + ".txt")
        assert os.path.exists(golden), f"missing golden {golden}"
        with open(golden, "rb") as fh:
            expected = fh.read()
        assert gunzip_bytes(p) == expected, (name, suffix)


def regenerate():
    """Write goldens from the REFERENCE binary (oracle)."""
    import subprocess
    import tempfile

    oracle = "/tmp/refbin/pandepth"
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        paths = _make_fixtures(tmp)
        for name, args in CONFIGS.items():
            out = os.path.join(tmp, f"ref_{name}")
            real_args = [a.format(**paths) for a in args]
            subprocess.run([oracle, "-i", paths["bam"], "-o", out]
                           + real_args, check=True, capture_output=True)
            for p in sorted(glob.glob(out + "*.gz")):
                suffix = os.path.basename(p)[len(f"ref_{name}"):]
                tgt = os.path.join(GOLDEN_DIR, name + suffix + ".txt")
                with open(tgt, "wb") as fh:
                    fh.write(gunzip_bytes(p))
                print("wrote", tgt)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    regenerate()
