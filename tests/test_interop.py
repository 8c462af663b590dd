"""Differential validation against REAL external binaries (plink2,
bcftools) when they exist on PATH — skipped otherwise, so the suite
self-upgrades the day the environment grows the toolchain (the
reference's correctness story is "matches plink2 export",
/root/reference/data/random1/random1.log:3-5).

Run `pytest -k interop` to see these as skipped-not-failed here.
"""

import shutil
import subprocess

import numpy as np
import pytest

from tests.cli_helpers import run_cli
from tests.conftest import build_fileset

plink2 = shutil.which("plink2")
bcftools = shutil.which("bcftools")


def _fileset(tmp_path, nvar=40, ns=12, seed=5):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(nvar, ns), dtype=np.uint8)
    pvar_rows = [
        f"1\t{100 + i}\trs{i}\tA\tG\t.\tPASS\t." for i in range(nvar)
    ]
    psam_rows = [f"s{i}\t{'M' if i % 2 else 'F'}" for i in range(ns)]
    return build_fileset(tmp_path, "io", codes, pvar_rows, psam_rows), codes


@pytest.mark.skipif(plink2 is None, reason="plink2 not on PATH")
def test_interop_plink2_vcf_export_body_matches(tmp_path):
    """plink2 --export vcf on the same fileset must agree on every
    CHROM/POS/ID/REF/ALT/GT cell (header lines differ by design:
    ##source tags)."""
    prefix, _ = _fileset(tmp_path)
    ours = tmp_path / "ours.vcf"
    assert run_cli(["filter", prefix, "-o", str(ours)]) == 0
    subprocess.run(
        [plink2, "--pfile", prefix, "--export", "vcf",
         "--out", str(tmp_path / "pl")],
        check=True, capture_output=True,
    )
    theirs = tmp_path / "pl.vcf"

    def rows(path):
        out = []
        for line in open(path):
            if line.startswith("#"):
                continue
            c = line.rstrip("\n").split("\t")
            # CHROM POS ID REF ALT + GT cells (plink2 may emit extra
            # FORMAT fields; take the leading GT of each sample cell)
            out.append(
                c[:5] + [cell.split(":")[0] for cell in c[9:]]
            )
        return out

    ours_rows = rows(ours)
    theirs_rows = rows(theirs)
    # plink2 writes phased-looking "/" too for mode-0x02 hard calls
    assert len(ours_rows) == len(theirs_rows)
    for a, b in zip(ours_rows, theirs_rows):
        assert a == [cell.replace("|", "/") for cell in b]


@pytest.mark.skipif(plink2 is None, reason="plink2 not on PATH")
def test_interop_plink2_freq_matches(tmp_path):
    prefix, _ = _fileset(tmp_path)
    ours = tmp_path / "ours.afreq"
    assert run_cli(["freq", prefix, "-o", str(ours)]) == 0
    subprocess.run(
        [plink2, "--pfile", prefix, "--freq",
         "--out", str(tmp_path / "pl")],
        check=True, capture_output=True,
    )
    mine = {
        r.split("\t")[1]: float(r.split("\t")[4])
        for r in open(ours).read().splitlines()[1:]
    }
    for r in open(tmp_path / "pl.afreq").read().splitlines()[1:]:
        c = r.split("\t")
        np.testing.assert_allclose(mine[c[1]], float(c[4]), atol=1e-6)


@pytest.mark.skipif(plink2 is None, reason="plink2 not on PATH")
def test_interop_plink2_hardy_matches(tmp_path):
    prefix, _ = _fileset(tmp_path)
    ours = tmp_path / "ours.hardy"
    assert run_cli(["hardy", prefix, "-o", str(ours)]) == 0
    subprocess.run(
        [plink2, "--pfile", prefix, "--hardy",
         "--out", str(tmp_path / "pl")],
        check=True, capture_output=True,
    )
    mine = {
        r.split("\t")[1]: float(r.split("\t")[-1])
        for r in open(ours).read().splitlines()[1:]
    }
    for r in open(tmp_path / "pl.hardy").read().splitlines()[1:]:
        c = r.split("\t")
        np.testing.assert_allclose(
            mine[c[1]], float(c[-1]), rtol=1e-6, atol=1e-12
        )


@pytest.mark.skipif(bcftools is None, reason="bcftools not on PATH")
def test_interop_bcftools_reads_our_bgzf_and_tabix(tmp_path):
    """bcftools must accept our BGZF-compressed VCF + .tbi and return
    the same region slice as our `view -r`."""
    prefix, _ = _fileset(tmp_path)
    gz = tmp_path / "o.vcf.gz"
    assert run_cli(["filter", prefix, "-o", str(gz)]) == 0
    assert run_cli(["index", str(gz)]) == 0
    ours = subprocess.run(
        ["python", "-m", "pgen_tpu.cli", "view", str(gz), "-r", "1:110-120",
         "-H"],
        check=True, capture_output=True, text=True,
    ).stdout
    theirs = subprocess.run(
        [bcftools, "view", "-H", "-r", "1:110-120", str(gz)],
        check=True, capture_output=True, text=True,
    ).stdout
    assert ours == theirs
