"""Tabix index emission + reader-side validation.

No tabix binary exists in the environment, so validation is reader-side:
`fetch_region` uses only the index structure (bins, chunks, linear index,
virtual offsets) to pull records, and its results must equal a brute-force
decompress-and-scan for randomized regions.
"""

import gzip

import numpy as np
import pytest

from pgen_tpu.formats.tabix import (
    bgzf_member_table,
    fetch_region,
    read_tbi,
    reg2bin,
    reg2bins,
    virtual_offsets,
)
from pgen_tpu.pipeline.filter import filter_to_vcf


def test_reg2bin_spec_values():
    # spec: level offsets 0, 1..8, 9..72, 73..584, 585..4680, 4681..37448
    assert reg2bin(0, 1) == 4681
    assert reg2bin(0, 1 << 14) == 4681
    assert reg2bin(0, (1 << 14) + 1) == 585
    assert reg2bin(1 << 14, (1 << 14) + 5) == 4682
    assert reg2bin(0, 1 << 29) == 0


def test_reg2bin_in_reg2bins():
    rng = np.random.default_rng(0)
    for _ in range(300):
        beg = int(rng.integers(0, 1 << 28))
        end = beg + int(rng.integers(1, 1 << 18))
        q0 = int(rng.integers(max(0, beg - 100), end + 100))
        q1 = q0 + int(rng.integers(1, 1 << 16))
        if q0 < end and beg < q1:  # overlapping query must include the bin
            assert reg2bin(beg, end) in reg2bins(q0, q1)


@pytest.fixture(scope="module")
def indexed_vcf(tmp_path_factory):
    from conftest import build_fileset

    td = tmp_path_factory.mktemp("tbx")
    rng = np.random.default_rng(21)
    nvar, nsamp = 900, 40  # several BGZF blocks of output
    codes = rng.integers(0, 4, size=(nvar, nsamp), dtype=np.uint8)
    # two chromosomes, non-trivial REF lengths, positions spread over 2^21
    pvar_rows = []
    pos = np.sort(rng.integers(1, 2_000_000, nvar // 2))
    for i in range(nvar // 2):
        ref = "ACGT"[: 1 + i % 4]
        pvar_rows.append(f"21\t{pos[i]}\tv{i}\t{ref}\tG\t.\t.\t.")
    pos2 = np.sort(rng.integers(1, 500_000, nvar - nvar // 2))
    for i in range(nvar - nvar // 2):
        pvar_rows.append(f"22\t{pos2[i]}\tw{i}\tA\tC\t.\t.\t.")
    prefix = build_fileset(
        td, "t", codes, pvar_rows, [f"s{i}\tM" for i in range(nsamp)]
    )
    gz = td / "t.vcf.gz"
    filter_to_vcf(prefix, out_file=gz, index=True)
    return gz


def test_member_table_roundtrip(indexed_vcf):
    c_offs, u_offs = bgzf_member_table(indexed_vcf)
    raw = gzip.decompress(indexed_vcf.read_bytes())
    assert u_offs[-1] == len(raw)
    assert c_offs[-1] == indexed_vcf.stat().st_size
    # virtual offset of position 0 is (0, 0)
    assert virtual_offsets(np.array([0]), c_offs, u_offs)[0] == 0


def test_tbi_structure(indexed_vcf):
    tbi = str(indexed_vcf) + ".tbi"
    names, refs = read_tbi(tbi)
    assert names == ["21", "22"]
    for name in names:
        bins, lidx = refs[name]
        assert bins and lidx
        for b, chunks in bins.items():
            for cb, ce in chunks:
                assert cb < ce


def _brute_force(gz, ref, beg, end):
    out = []
    for line in gzip.decompress(gz.read_bytes()).split(b"\n"):
        if not line or line.startswith(b"#"):
            continue
        cols = line.split(b"\t", 4)
        if cols[0].decode() != ref:
            continue
        p0 = int(cols[1]) - 1
        if p0 < end and p0 + max(len(cols[3]), 1) > beg:
            out.append(line)
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fetch_matches_brute_force(indexed_vcf, seed):
    tbi = str(indexed_vcf) + ".tbi"
    rng = np.random.default_rng(seed)
    for ref, span in (("21", 2_000_000), ("22", 500_000)):
        for _ in range(12):
            beg = int(rng.integers(0, span))
            end = beg + int(rng.integers(1, span // 3))
            got = fetch_region(str(indexed_vcf), tbi, ref, beg, end)
            want = _brute_force(indexed_vcf, ref, beg, end)
            assert got == want, (ref, beg, end)


def test_fetch_whole_and_empty(indexed_vcf):
    tbi = str(indexed_vcf) + ".tbi"
    all21 = fetch_region(str(indexed_vcf), tbi, "21", 0, 1 << 29)
    assert len(all21) == 450
    assert fetch_region(str(indexed_vcf), tbi, "19", 0, 1 << 29) == []
    assert fetch_region(str(indexed_vcf), tbi, "21", 3_000_000, 4_000_000) == []


def test_cli_index_flag(tmp_path):
    from conftest import build_fileset
    from cli_helpers import run_cli

    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=(30, 7), dtype=np.uint8)
    prefix = build_fileset(
        tmp_path,
        "c",
        codes,
        [f"1\t{100 + i}\tr{i}\tA\tC\t.\t.\t." for i in range(30)],
        [f"s{i}\tF" for i in range(7)],
    )
    out = tmp_path / "c.vcf.gz"
    assert run_cli(["filter", prefix, "-o", str(out), "--index"]) == 0
    assert (tmp_path / "c.vcf.gz.tbi").exists()
    names, _ = read_tbi(str(out) + ".tbi")
    assert names == ["1"]
    # --index without .gz is a clean error
    assert run_cli(["filter", prefix, "-o", str(tmp_path / "p.vcf"), "--index"]) == 1


def test_index_requires_gz(tmp_path):
    from conftest import build_fileset

    codes = np.zeros((2, 3), dtype=np.uint8)
    prefix = build_fileset(
        tmp_path,
        "e",
        codes,
        ["1\t5\ta\tA\tC\t.\t.\t.", "1\t9\tb\tA\tC\t.\t.\t."],
        ["s0\tM", "s1\tM", "s2\tM"],
    )
    with pytest.raises(ValueError, match="gz"):
        filter_to_vcf(prefix, out_file=tmp_path / "e.vcf", index=True)


# -- CSI (.csi) generalized index -------------------------------------------


def test_reg2bin_csi_matches_tbi_binning():
    from pgen_tpu.formats.tabix import reg2bin_csi, reg2bins_csi

    rng = np.random.default_rng(7)
    for _ in range(400):
        beg = int(rng.integers(0, 1 << 28))
        end = beg + int(rng.integers(1, 1 << 20))
        assert reg2bin_csi(beg, end) == reg2bin(beg, end)
    assert reg2bins_csi(12345, 700_000) == sorted(reg2bins(12345, 700_000))


def test_reg2bin_csi_beyond_tbi_limit():
    from pgen_tpu.formats.tabix import reg2bin_csi, reg2bins_csi

    # positions past 2^29 bin at depth 6 (capacity 2^32), and the query
    # set contains the record's bin
    beg = (1 << 30) + 12345
    b = reg2bin_csi(beg, beg + 10, depth=6)
    assert b > 0
    assert b in reg2bins_csi(beg - 5, beg + 20, depth=6)


@pytest.fixture(scope="module")
def csi_vcf(tmp_path_factory):
    from conftest import build_fileset

    td = tmp_path_factory.mktemp("csi")
    rng = np.random.default_rng(31)
    nvar, nsamp = 700, 31
    codes = rng.integers(0, 4, size=(nvar, nsamp), dtype=np.uint8)
    # one long contig with positions past the .tbi 2^29 ceiling
    pos = np.sort(rng.integers(1, (1 << 30) + (1 << 21), nvar))
    pvar_rows = [
        f"1\t{pos[i]}\tv{i}\t{'ACGT'[: 1 + i % 4]}\tG\t.\t.\t." for i in range(nvar)
    ]
    prefix = build_fileset(
        td, "L", codes, pvar_rows, [f"s{i}\tM" for i in range(nsamp)]
    )
    gz = td / "L.vcf.gz"
    filter_to_vcf(prefix, out_file=gz, index=True)  # auto -> .csi
    return gz


def test_auto_switches_to_csi(csi_vcf):
    import os

    assert os.path.exists(str(csi_vcf) + ".csi")
    assert not os.path.exists(str(csi_vcf) + ".tbi")


def test_csi_structure(csi_vcf):
    from pgen_tpu.formats.tabix import read_csi

    names, refs, min_shift, depth = read_csi(str(csi_vcf) + ".csi")
    assert names == ["1"]
    assert min_shift == 14
    # depth grew to cover positions past 2^29 (capacity 2^(14+3*depth))
    assert depth == 6
    bins = refs["1"]
    assert bins
    for b, (loff, chunks) in bins.items():
        for cb, ce in chunks:
            assert cb < ce
            assert loff <= cb  # loffset precedes the bin's own chunks


@pytest.mark.parametrize("seed", [11, 12])
def test_csi_fetch_matches_brute_force(csi_vcf, seed):
    csi = str(csi_vcf) + ".csi"
    rng = np.random.default_rng(seed)
    span = (1 << 30) + (1 << 21)
    for _ in range(12):
        beg = int(rng.integers(0, span))
        end = beg + int(rng.integers(1, span // 3))
        got = fetch_region(str(csi_vcf), csi, "1", beg, end)
        want = _brute_force(csi_vcf, "1", beg, end)
        assert got == want, (beg, end)
    # whole-contig and empty-region queries
    assert len(fetch_region(str(csi_vcf), csi, "1", 0, 1 << 31)) == 700
    assert fetch_region(str(csi_vcf), csi, "2", 0, 1 << 31) == []


def test_explicit_tbi_rejects_long_positions(tmp_path):
    from conftest import build_fileset

    codes = np.zeros((2, 3), dtype=np.uint8)
    prefix = build_fileset(
        tmp_path,
        "x",
        codes,
        [f"1\t{(1 << 29) + 7}\ta\tA\tC\t.\t.\t.", f"1\t{(1 << 29) + 9}\tb\tA\tC\t.\t.\t."],
        ["s0\tM", "s1\tM", "s2\tM"],
    )
    with pytest.raises(ValueError, match="2\\^29"):
        filter_to_vcf(
            prefix, out_file=tmp_path / "x.vcf.gz", index=True, index_format="tbi"
        )


def test_cli_index_format_csi(tmp_path):
    from conftest import build_fileset
    from cli_helpers import run_cli

    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, size=(25, 5), dtype=np.uint8)
    prefix = build_fileset(
        tmp_path,
        "k",
        codes,
        [f"1\t{100 + i}\tr{i}\tA\tC\t.\t.\t." for i in range(25)],
        [f"s{i}\tF" for i in range(5)],
    )
    out = tmp_path / "k.vcf.gz"
    assert (
        run_cli(["filter", prefix, "-o", str(out), "--index", "--index-format", "csi"])
        == 0
    )
    assert (tmp_path / "k.vcf.gz.csi").exists()
    got = fetch_region(str(out), str(out) + ".csi", "1", 0, 1000)
    assert len(got) == 25


def test_index_with_workers_merged_gz(tmp_path):
    """--workers N -o out.vcf.gz --index: the merged sharded BGZF stream
    gets a valid index (parent re-derives the deterministic row layout)."""
    from conftest import build_fileset
    from pgen_tpu.parallel.shard import filter_to_vcf_parallel

    rng = np.random.default_rng(17)
    nvar, nsamp = 300, 11
    codes = rng.integers(0, 4, size=(nvar, nsamp), dtype=np.uint8)
    pos = np.sort(rng.integers(1, 900_000, nvar))
    prefix = build_fileset(
        tmp_path,
        "w",
        codes,
        [f"7\t{pos[i]}\tv{i}\tA\tG\t.\t.\t." for i in range(nvar)],
        [f"s{i}\tM" for i in range(nsamp)],
    )
    out = tmp_path / "w.vcf.gz"
    filter_to_vcf_parallel(
        prefix, out_file=str(out), num_workers=3, index=True
    )
    tbi = str(out) + ".tbi"
    import os

    assert os.path.exists(tbi)
    rng2 = np.random.default_rng(18)
    for _ in range(8):
        beg = int(rng2.integers(0, 900_000))
        end = beg + int(rng2.integers(1, 300_000))
        assert fetch_region(str(out), tbi, "7", beg, end) == _brute_force(
            out, "7", beg, end
        )


def test_index_with_shards_sequential_gz(tmp_path):
    from conftest import build_fileset
    from pgen_tpu.parallel.shard import filter_to_vcf_sharded

    rng = np.random.default_rng(19)
    codes = rng.integers(0, 4, size=(120, 9), dtype=np.uint8)
    prefix = build_fileset(
        tmp_path,
        "sq",
        codes,
        [f"3\t{50 + 13 * i}\tv{i}\tAC\tG\t.\t.\t." for i in range(120)],
        [f"s{i}\tF" for i in range(9)],
    )
    out = tmp_path / "sq.vcf.gz"
    filter_to_vcf_sharded(prefix, out_file=str(out), num_shards=3, index=True)
    got = fetch_region(str(out), str(out) + ".tbi", "3", 100, 800)
    assert got == _brute_force(out, "3", 100, 800)
    # a single standalone shard cannot be indexed (incomplete file)
    with pytest.raises(ValueError, match="complete"):
        filter_to_vcf_sharded(
            prefix,
            out_file=str(tmp_path / "p.vcf.gz.shard0000.part"),
            num_shards=3,
            shard_index=0,
            standalone=True,
            index=True,
        )


def test_bulk_add_many_matches_scalar_add():
    """The vectorized bulk writer path must serialize byte-identically to
    the scalar add() loop (chunk merging, lidx sentinel, loffsets)."""
    from pgen_tpu.formats.tabix import CsiWriter, TbiWriter

    rng = np.random.default_rng(3)
    n = 5000
    pos0 = np.sort(rng.integers(0, 3_000_000, n)).astype(np.int64)
    ends = pos0 + rng.integers(1, 5, n)
    vbeg = 100 + np.arange(n, dtype=np.int64) * 777
    vend = vbeg + 777 - rng.integers(0, 2, n)  # break some merges
    for cls in (TbiWriter, CsiWriter):
        bulk = cls()
        bulk.add_many("7", pos0, ends, vbeg, vend)
        scalar = cls()
        for i in range(n):
            scalar.add("7", int(pos0[i]), int(ends[i]), int(vbeg[i]), int(vend[i]))
        assert bulk.serialize() == scalar.serialize(), cls.__name__


def test_fetch_keeps_duplicate_rows(tmp_path):
    """Two byte-identical VCF rows must BOTH come back from an indexed
    region query (chunk-merge, not content-dedup)."""
    from conftest import build_fileset

    codes = np.zeros((2, 3), dtype=np.uint8)
    prefix = build_fileset(
        tmp_path,
        "dup",
        codes,
        ["5\t42\tdup\tA\tC\t.\t.\t.", "5\t42\tdup\tA\tC\t.\t.\t."],
        ["s0\tM", "s1\tM", "s2\tM"],
    )
    out = tmp_path / "dup.vcf.gz"
    filter_to_vcf(prefix, out_file=out, index=True)
    got = fetch_region(str(out), str(out) + ".tbi", "5", 0, 100)
    assert len(got) == 2 and got[0] == got[1]


def test_pos_zero_row_indexed_and_fetchable(tmp_path):
    """POS=0 (legal telomere coordinate) gives beg=-1 before clamping;
    htslib clamps beg<0 to 0. Un-clamped it lands in a wrong bin (4680)
    or crashes the linear-index fill — the row must instead come back
    from a [0, N) region query, via both the bulk and scalar paths."""
    from conftest import build_fileset

    from pgen_tpu.formats.tabix import CsiWriter, TbiWriter, reg2bin_vec

    # vectorized binning: clamped inside add_many; raw reg2bin_vec on the
    # clamped beg must give the same bin as a POS=1 row of the same span
    assert reg2bin_vec([0], [1])[0] == reg2bin(0, 1)

    codes = np.zeros((3, 2), dtype=np.uint8)
    prefix = build_fileset(
        tmp_path,
        "tel",
        codes,
        ["9\t0\ttel\tA\tC\t.\t.\t.", "9\t5\tv1\tA\tC\t.\t.\t.", "9\t9\tv2\tAC\tG\t.\t.\t."],
        ["s0\tM", "s1\tM"],
    )
    out = tmp_path / "tel.vcf.gz"
    filter_to_vcf(prefix, out_file=out, index=True)
    got = fetch_region(str(out), str(out) + ".tbi", "9", 0, 3)
    assert len(got) == 1 and got[0].split(b"\t")[1] == b"0"
    assert len(fetch_region(str(out), str(out) + ".tbi", "9", 0, 100)) == 3

    # scalar add() path must accept beg=-1 and agree with the bulk writer
    for cls in (TbiWriter, CsiWriter):
        scalar = cls()
        scalar.add("9", -1, 0, 100, 200)
        bulk = cls()
        bulk.add_many("9", [-1], [0], [100], [200])
        assert scalar.serialize() == bulk.serialize(), cls.__name__
