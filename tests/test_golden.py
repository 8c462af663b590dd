"""Frozen golden outputs (SURVEY.md §4).

Unlike the differential tests (which compare against tests/oracle.py — an
independent implementation but same-author), these expectations are
LITERAL BYTES derived by hand from the reference's emission code
(/root/reference/src/pfile.rs:136-191) and frozen here:

* pgen geometry: 12-byte header (magic 6C 1B, mode 02, LE-u32 counts,
  format 40), records of ceil(2S/8) bytes at 12 + v*rec (pfile.rs:38-76,
  165, 196-200).
* 2-bit codes LSB-first within each byte; 00->0/0 01->0/1 10->1/1 11->./.
  (pfile.rs:171-183).
* header: ##fileformat=VCFv4.2, ##source=pgen-rs, pvar comments verbatim,
  then column line + "\tFORMAT\t" + IID-tab-join (pfile.rs:136-146).
* body: pvar data line verbatim + "\tGT" + "\t"+token per kept sample
  (pfile.rs:156-191).

A corrupted oracle cannot re-green this file: the expected bytes are
committed, not recomputed. The packed genotype bytes below were computed
by hand (shown in comments) — review them against the bullet list above.
"""

import hashlib
import struct

import pytest

from pgen_tpu.pipeline.filter import filter_to_vcf


def _write_fileset(tmp_path, name, pgen_records, nvar, nsamp, pvar_text, psam_text):
    prefix = tmp_path / name
    header = b"\x6c\x1b\x02" + struct.pack("<II", nvar, nsamp) + b"\x40"
    assert len(header) == 12
    (tmp_path / f"{name}.pgen").write_bytes(header + pgen_records)
    (tmp_path / f"{name}.pvar").write_text(pvar_text)
    (tmp_path / f"{name}.psam").write_text(psam_text)
    return str(prefix)


# 3 variants x 5 samples. rec_size = ceil(2*5/8) = 2 bytes (partial tail
# byte: only 2 bits of byte 1 are meaningful).
#   v1 codes [0,1,2,3,0]: byte0 = 0 | 1<<2 | 2<<4 | 3<<6 = 0xE4, byte1 = 0x00
#   v2 codes [3,3,3,3,3]: byte0 = 0xFF, byte1 = 0x03
#   v3 codes [2,0,1,0,2]: byte0 = 2 | 1<<4 = 0x12, byte1 = 0x02
CASE1_RECORDS = bytes([0xE4, 0x00, 0xFF, 0x03, 0x12, 0x02])

CASE1_PVAR = (
    "##contig=<ID=1>\n"
    "#CHROM\tPOS\tID\tREF\tALT\n"
    "1\t100\tv1\tA\tG\n"
    "1\t200\tv2\tC\tT\n"
    "1\t300\tv3\tG\tA\n"
)

CASE1_PSAM = "#IID\tSEX\ns0\tM\ns1\tF\ns2\tM\ns3\tF\ns4\tM\n"

GOLDEN_KEEP_ALL = (
    b"##fileformat=VCFv4.2\n"
    b"##source=pgen-rs\n"
    b"##contig=<ID=1>\n"
    b"#CHROM\tPOS\tID\tREF\tALT\tFORMAT\ts0\ts1\ts2\ts3\ts4\n"
    b"1\t100\tv1\tA\tG\tGT\t0/0\t0/1\t1/1\t./.\t0/0\n"
    b"1\t200\tv2\tC\tT\tGT\t./.\t./.\t./.\t./.\t./.\n"
    b"1\t300\tv3\tG\tA\tGT\t1/1\t0/0\t0/1\t0/0\t1/1\n"
)

# var POS!="200" keeps v1,v3; sam SEX=="M" keeps s0,s2,s4.
#   v1 [0,1,2,3,0] -> s0=0/0 s2=1/1 s4=0/0
#   v3 [2,0,1,0,2] -> s0=1/1 s2=0/1 s4=1/1
GOLDEN_FILTERED = (
    b"##fileformat=VCFv4.2\n"
    b"##source=pgen-rs\n"
    b"##contig=<ID=1>\n"
    b"#CHROM\tPOS\tID\tREF\tALT\tFORMAT\ts0\ts2\ts4\n"
    b"1\t100\tv1\tA\tG\tGT\t0/0\t1/1\t0/0\n"
    b"1\t300\tv3\tG\tA\tGT\t1/1\t0/1\t1/1\n"
)

GOLDEN_EMPTY = (
    b"##fileformat=VCFv4.2\n"
    b"##source=pgen-rs\n"
    b"##contig=<ID=1>\n"
    b"#CHROM\tPOS\tID\tREF\tALT\tFORMAT\ts0\ts1\ts2\ts3\ts4\n"
)


@pytest.fixture()
def case1(tmp_path):
    return _write_fileset(
        tmp_path, "g1", CASE1_RECORDS, 3, 5, CASE1_PVAR, CASE1_PSAM
    )


@pytest.mark.parametrize("provider", ["native", "device", "numpy"])
def test_golden_keep_all(case1, tmp_path, provider):
    out = tmp_path / "a.vcf"
    filter_to_vcf(case1, out_file=out, provider=provider)
    assert out.read_bytes() == GOLDEN_KEEP_ALL


@pytest.mark.parametrize("provider", ["native", "device", "numpy"])
def test_golden_filtered(case1, tmp_path, provider):
    out = tmp_path / "b.vcf"
    filter_to_vcf(
        case1,
        var_query='POS != "200"',
        sam_query='SEX == "M"',
        out_file=out,
        provider=provider,
    )
    assert out.read_bytes() == GOLDEN_FILTERED


def test_golden_empty_filter(case1, tmp_path):
    out = tmp_path / "c.vcf"
    filter_to_vcf(case1, var_query='POS == "999"', out_file=out)
    assert out.read_bytes() == GOLDEN_EMPTY


def test_golden_query_stdout(case1, capsys):
    from pgen_tpu.pipeline.query import query_metadata

    query_metadata(case1, query_fstring='ID + ":" + ALT', query='REF != "C"')
    assert capsys.readouterr().out == "v1:G\nv3:A\n"


# -- basic1 config hashes ---------------------------------------------------
#
# data/basic1 is the deterministic chr19 fixture (tools/make_fixtures.py,
# seeded RNG over the committed .pvar/.psam). These SHA-256 digests were
# recorded once and reviewed: row counts cross-checked against the
# metadata-only query path, spot rows decoded by hand from the packed
# bytes, and all three providers produced identical bytes. Any change to
# emission, predicate, or fixture code that alters output bytes must be
# justified and these digests re-frozen.

BASIC1_SHA256 = {
    # filter --include-sam 'IID=="NA20900"' --include-var 'ALT=="G"'
    # (BASELINE.json PR1 config): 168 header lines + 4130 rows
    "pr1": "64e45a18eb62a0e70f955c45435b8525116021dd916e787b75d69d1251afca71",
    # filter keep-all variants for one sample
    "keep_all_one_sample": "a8d0e9d11206392116867fae904c8c8ed6397eb19d29defa5f158627363f7543",
}


def test_basic1_frozen_hashes(basic1_prefix, tmp_path):
    out = tmp_path / "p.vcf"
    filter_to_vcf(
        basic1_prefix,
        var_query='ALT=="G"',
        sam_query='IID=="NA20900"',
        out_file=out,
    )
    data = out.read_bytes()
    assert data.count(b"\n", 0, len(data)) == 168 + 4130
    assert hashlib.sha256(data).hexdigest() == BASIC1_SHA256["pr1"]

    out2 = tmp_path / "k.vcf"
    filter_to_vcf(basic1_prefix, sam_query='IID=="NA20900"', out_file=out2)
    assert hashlib.sha256(out2.read_bytes()).hexdigest() == BASIC1_SHA256[
        "keep_all_one_sample"
    ]


# -- frozen king/glm conventions ------------------------
#
# The king --cutoff greedy order and the glm column layout are "plink2
# conventions by construction" — unverifiable against a plink2 binary in
# this environment — so their outputs are FROZEN here as literal bytes,
# hand-derived where the arithmetic permits (shown in comments).


def test_golden_king_cutoff_and_table(tmp_path):
    """4 samples, 4 variants, hand-derived KING-robust kinships.

    codes (variant x sample):
        v0  1 1 1 0      v1  1 1 1 0      v2  0 0 0 0      v3  2 2 2 0
    s0 == s1 == s2 (identical): for any pair among them over the 4 shared
    variants HETHET = 2 (v0, v1), IBS0 = 0, het_i = het_j = 2, so
    KINSHIP = (2 - 2*0) / (2 + 2) = 0.5 (duplicate-sample value).
    s3 is all hom-ref: HETHET = 0; v3 gives |2-0| = 2 -> IBS0 = 1;
    KINSHIP = (0 - 2*1)/(2 + 0) = -1.
    Emitted fractions divide by NSNP=4: HETHET 0.5, IBS0 0.25.

    --cutoff 0.25: over-cutoff degrees (2,2,2,0) -> tie removes the LATER
    index s2; then (1,1,0) -> removes s1; keep = {s0, s3}.
    """
    import numpy as np
    from pgen_tpu.formats.writer import write_pgen
    from pgen_tpu.pipeline.king import king_table

    codes = np.array(
        [[1, 1, 1, 0], [1, 1, 1, 0], [0, 0, 0, 0], [2, 2, 2, 0]],
        dtype=np.uint8,
    )
    name = "kg"
    write_pgen(str(tmp_path / f"{name}.pgen"), codes)
    (tmp_path / f"{name}.pvar").write_text(
        "#CHROM\tPOS\tID\tREF\tALT\n"
        + "".join(f"1\t{100 + i}\tv{i}\tA\tG\n" for i in range(4))
    )
    (tmp_path / f"{name}.psam").write_text(
        "#IID\tSEX\n" + "".join(f"s{i}\tM\n" for i in range(4))
    )
    prefix = str(tmp_path / name)

    king_table(prefix, out_file=str(tmp_path / "t.kin0"))
    assert (tmp_path / "t.kin0").read_bytes() == (
        b"#IID1\tIID2\tNSNP\tHETHET\tIBS0\tKINSHIP\n"
        b"s0\ts1\t4\t0.5\t0\t0.5\n"
        b"s0\ts2\t4\t0.5\t0\t0.5\n"
        b"s0\ts3\t4\t0\t0.25\t-1\n"
        b"s1\ts2\t4\t0.5\t0\t0.5\n"
        b"s1\ts3\t4\t0\t0.25\t-1\n"
        b"s2\ts3\t4\t0\t0.25\t-1\n"
    )

    king_table(prefix, out_file=str(tmp_path / "c"), cutoff=0.25)
    assert (tmp_path / "c.king.cutoff.in.id").read_bytes() == b"s0\ns3\n"
    assert (tmp_path / "c.king.cutoff.out.id").read_bytes() == b"s1\ns2\n"


def test_golden_glm_linear_columns(tmp_path):
    """Hand-derived OLS on g=[0,1,2,1], y=[1,2,4,2]:
    mean g = 1, mean y = 2.25; Sxy = 3, Sxx = 2 -> BETA = 1.5;
    residuals (0.25,-0.25,0.25,-0.25) -> rss = 0.25, df = 2,
    SE = sqrt((rss/df)/Sxx) = 0.25, T = 6;
    P = 2*sf_t2(6) = 1 - 6/sqrt(38) = 0.0266715 (6 s.f.).
    Second variant is all-missing -> plink2-style NA row."""
    import numpy as np
    from pgen_tpu.formats.writer import write_pgen
    from pgen_tpu.pipeline.glm import glm_pfile

    codes = np.array([[0, 1, 2, 1], [3, 3, 3, 3]], dtype=np.uint8)
    name = "gg"
    write_pgen(str(tmp_path / f"{name}.pgen"), codes)
    (tmp_path / f"{name}.pvar").write_text(
        "#CHROM\tPOS\tID\tREF\tALT\n"
        "1\t100\tv0\tA\tG\n"
        "1\t101\tv1\tC\tT\n"
    )
    (tmp_path / f"{name}.psam").write_text(
        "#IID\tPHENO1\n" + "".join(
            f"s{i}\t{p}\n" for i, p in enumerate(["1", "2", "4", "2"])
        )
    )
    out = tmp_path / "g.glm"
    glm_pfile(str(tmp_path / name), out_file=str(out))
    assert out.read_bytes() == (
        b"#CHROM\tPOS\tID\tREF\tALT\tA1\tTEST\tOBS_CT\tBETA\tSE\tT_STAT\tP\n"
        b"1\t100\tv0\tA\tG\tG\tADD\t4\t1.5\t0.25\t6\t0.0266715\n"
        b"1\t101\tv1\tC\tT\tT\tADD\t0\tNA\tNA\tNA\tNA\n"
    )
