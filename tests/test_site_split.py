"""Per-contig split site-dump tests (deep-coverage ``-a``).

``run._run_site_split`` processes one contig per BAI-ranged pass so a
deep site dump is O(max contig events) instead of O(file events).
Forced on via PANDEPTH_SITE_SPLIT=1, the output must be byte-identical to both the
reference binary and our own one-shot path — SiteDepth rows AND every
stat table.
"""

import glob
import os
import subprocess

import pytest

from tests.fixtures import gunzip_bytes, make_bam, make_gff


def _run(tmp_path, monkeypatch, extra, split: bool):
    from pandepth_jax.cli import main as cli_main

    tag = "split" if split else "oneshot"
    monkeypatch.setenv("PANDEPTH_HOST_FINALIZE", "1")
    if split:
        monkeypatch.setenv("PANDEPTH_SITE_SPLIT", "1")
    else:
        monkeypatch.setenv("PANDEPTH_SITE_SPLIT", "0")
    out = str(tmp_path / tag)
    rc = cli_main(["pandepth", "-i", str(tmp_path / "t.bam"), "-a",
                   "-o", out] + extra)
    assert rc == 0
    return out


@pytest.mark.parametrize("targets", ["chr", "gene"])
def test_site_split_matches_reference_and_oneshot(tmp_path, targets,
                                                  oracle_bin,
                                                  monkeypatch):
    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=900, seed=41)
    extra = []
    if targets == "gene":
        gff = str(tmp_path / "g.gff")
        make_gff(gff, overhang=False)
        extra = ["-g", gff]
    ref = str(tmp_path / "ref")
    subprocess.run([oracle_bin, "-i", bam, "-a", "-o", ref] + extra,
                   check=True, capture_output=True)
    split = _run(tmp_path, monkeypatch, extra, split=True)
    oneshot = _run(tmp_path, monkeypatch, extra, split=False)
    ref_files = sorted(glob.glob(ref + "*.gz"))
    assert ref_files
    for rf in ref_files:
        suffix = os.path.basename(rf)[len("ref"):]
        sp = split + suffix
        os_ = oneshot + suffix
        assert gunzip_bytes(sp) == gunzip_bytes(rf), suffix
        # byte-identical compressed framing vs our one-shot too
        assert gunzip_bytes(sp) == gunzip_bytes(os_), suffix


def test_site_split_elects_by_size(tmp_path, monkeypatch):
    """The default election is by compressed input size: below the
    threshold the one-shot path runs, above it the split path does
    (observed via the election's own code path, not timing)."""
    import pandepth_jax.run as run_mod

    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=300, seed=47)
    calls = []
    real = run_mod._run_site_split

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(run_mod, "_run_site_split", spy)
    monkeypatch.setenv("PANDEPTH_HOST_FINALIZE", "1")
    monkeypatch.delenv("PANDEPTH_SITE_SPLIT", raising=False)
    from pandepth_jax.cli import main as cli_main

    # tiny threshold -> split elected
    monkeypatch.setenv("PANDEPTH_SITE_SPLIT_BYTES", "1")
    assert cli_main(["pandepth", "-i", bam, "-a",
                     "-o", str(tmp_path / "a")]) == 0
    assert calls == [1]
    # huge threshold -> one-shot
    monkeypatch.setenv("PANDEPTH_SITE_SPLIT_BYTES", str(1 << 60))
    assert cli_main(["pandepth", "-i", bam, "-a",
                     "-o", str(tmp_path / "b")]) == 0
    assert calls == [1]


@pytest.mark.parametrize("dump", [False, True])
def test_list_split_matches_reference_and_oneshot(tmp_path, dump,
                                                  oracle_bin,
                                                  monkeypatch):
    """Multi-sample ``.list`` through the per-contig split passes
    (pooled depth across files, first-file contig space): byte parity
    vs the reference AND vs our one-shot multi-file loop, with and
    without ``-a``."""
    from pandepth_jax.cli import main as cli_main

    bams = []
    for k, seed in enumerate((51, 52, 53)):
        b = str(tmp_path / f"s{k}.bam")
        # the reference's multi-file arrays only carry +100 slack
        # cells past each contig (src/PanDepth.cpp:2687-2699)
        make_bam(b, n=500, seed=seed, end_slack=50)
        bams.append(b)
    lst = str(tmp_path / "in.list")
    with open(lst, "w") as fh:
        fh.write("\n".join(bams) + "\n")
    extra = ["-a"] if dump else []
    ref = str(tmp_path / "ref")
    subprocess.run([oracle_bin, "-i", lst, "-o", ref] + extra,
                   check=True, capture_output=True)
    monkeypatch.setenv("PANDEPTH_HOST_FINALIZE", "1")
    monkeypatch.setenv("PANDEPTH_SITE_SPLIT", "1")
    # the election must actually take the split path (an earlier
    # regression left it one-shot and this test green)
    import pandepth_jax.run as run_mod

    calls = []
    real = run_mod._run_site_split

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(run_mod, "_run_site_split", spy)
    split = str(tmp_path / "split")
    assert cli_main(["pandepth", "-i", lst, "-o", split]
                    + extra) == 0
    assert calls == [1]
    monkeypatch.setenv("PANDEPTH_SITE_SPLIT", "0")
    oneshot = str(tmp_path / "oneshot")
    assert cli_main(["pandepth", "-i", lst, "-o", oneshot]
                    + extra) == 0
    ref_files = sorted(glob.glob(ref + "*.gz"))
    assert ref_files
    for rf in ref_files:
        suffix = os.path.basename(rf)[len("ref"):]
        assert gunzip_bytes(split + suffix) == gunzip_bytes(rf), \
            suffix
        assert gunzip_bytes(split + suffix) == \
            gunzip_bytes(oneshot + suffix), suffix


def test_site_split_mapq_filter(tmp_path, oracle_bin, monkeypatch):
    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=700, seed=43)
    ref = str(tmp_path / "ref")
    subprocess.run([oracle_bin, "-i", bam, "-a", "-q", "30",
                    "-o", ref], check=True, capture_output=True)
    split = _run(tmp_path, monkeypatch, ["-q", "30"], split=True)
    for rf in sorted(glob.glob(ref + "*.gz")):
        suffix = os.path.basename(rf)[len("ref"):]
        assert gunzip_bytes(split + suffix) == gunzip_bytes(rf), \
            suffix
