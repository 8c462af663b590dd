"""End-to-end device-mesh filter.

`filter_to_vcf_mesh` — the function `pgen-tpu filter --provider device`
drives — must produce byte-identical VCFs to the host providers from an
8-virtual-device CPU mesh, across predicate kinds (device-lowered,
host-mask fallback), sample subsets, block boundaries, and empty results.
"""

import numpy as np
import pytest

from pgen_tpu.pipeline.filter import filter_to_vcf
from pgen_tpu.pipeline.mesh_filter import filter_to_vcf_mesh

from oracle import scalar_filter_vcf


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def fileset(tmp_path_factory):
    from conftest import build_fileset

    td = tmp_path_factory.mktemp("meshfs")
    rng = np.random.default_rng(3)
    nvar, nsamp = 531, 37  # non-multiples of the 8-device mesh and of 4
    codes = rng.integers(0, 4, size=(nvar, nsamp), dtype=np.uint8)
    prefix = build_fileset(
        td,
        "m",
        codes,
        [
            f"1\t{i}\tr{i}\tA\t{rng.choice(['C', 'G'])}\t.\t.\t."
            for i in range(nvar)
        ],
        [f"s{i}\tM" for i in range(nsamp)],
    )
    return prefix


CONFIGS = [
    (None, None),  # keep-all
    ('ALT == "G"', None),  # device-lowered predicate
    ('ALT == "G"', 'IID != "s3"'),  # + sample subset (device gather)
    ('POS == "9999"', None),  # empty result
    ('len(ID) == 2', None),  # builtin -> host-mask fallback path
    ('ALT == "G" || POS == "7"', None),  # boolean combine on device
]


@pytest.mark.parametrize("vq,sq", CONFIGS)
def test_mesh_matches_host(fileset, tmp_path, vq, sq):
    a = tmp_path / "host.vcf"
    b = tmp_path / "mesh.vcf"
    filter_to_vcf(fileset, var_query=vq, sam_query=sq, out_file=a)
    res = filter_to_vcf_mesh(
        fileset, var_query=vq, sam_query=sq, out_file=str(b), block_variants=128
    )
    assert _read(a) == _read(b)
    assert res.bytes_written == len(_read(b))


def test_mesh_single_block(fileset, tmp_path):
    # whole file in one (padded) block
    a = tmp_path / "h.vcf"
    b = tmp_path / "m.vcf"
    filter_to_vcf(fileset, var_query='ALT == "C"', out_file=a)
    filter_to_vcf_mesh(fileset, var_query='ALT == "C"', out_file=str(b))
    assert _read(a) == _read(b)


def test_mesh_matches_oracle(tiny_fileset, tmp_path):
    prefix, _ = tiny_fileset
    out = tmp_path / "t.vcf"
    filter_to_vcf_mesh(prefix, var_query='REF == "A"', out_file=str(out))
    assert _read(out) == scalar_filter_vcf(prefix, lambda v: v["REF"] == "A", None)


def test_mesh_gt_stats_query(fileset, tmp_path):
    # GT_* extension variables force the host-mask path; the decode/text
    # still runs on the mesh
    a = tmp_path / "h.vcf"
    b = tmp_path / "m.vcf"
    q = "GT_MISSING < 20"
    filter_to_vcf(fileset, var_query=q, out_file=a)
    filter_to_vcf_mesh(fileset, var_query=q, out_file=str(b), block_variants=256)
    assert _read(a) == _read(b)


def test_cli_provider_device_uses_mesh(fileset, tmp_path, monkeypatch):
    """`filter --provider device` must drive the mesh pipeline."""
    import pgen_tpu.pipeline.mesh_filter as mf
    from cli_helpers import run_cli

    called = {}
    orig = mf.filter_to_vcf_mesh

    def spy(*a, **k):
        called["yes"] = True
        return orig(*a, **k)

    monkeypatch.setattr(mf, "filter_to_vcf_mesh", spy)
    out = tmp_path / "c.vcf"
    ref = tmp_path / "r.vcf"
    code = run_cli(
        [
            "filter",
            fileset,
            "--include-var",
            'ALT == "G"',
            "--provider",
            "device",
            "-o",
            str(out),
        ]
    )
    assert code == 0
    assert called.get("yes"), "CLI device provider did not call the mesh path"
    filter_to_vcf(fileset, var_query='ALT == "G"', out_file=ref)
    assert _read(out) == _read(ref)


@pytest.mark.parametrize(
    "vq,sq",
    [
        (None, None),
        ('ALT == "G"', 'IID != "s3"'),
        ('POS == "9999"', None),  # empty result: header + EOF only
    ],
)
def test_mesh_gz_matches_host(fileset, tmp_path, vq, sq):
    """.gz on the mesh path: the BGZF stream must
    decompress byte-equal to the host path's output."""
    import gzip

    from pgen_tpu.native import HAVE_NATIVE

    if not HAVE_NATIVE:
        pytest.skip("bgzf requires the native runtime")
    a = tmp_path / "host.vcf"
    b = tmp_path / "mesh.vcf.gz"
    filter_to_vcf(fileset, var_query=vq, sam_query=sq, out_file=a)
    res = filter_to_vcf_mesh(
        fileset, var_query=vq, sam_query=sq, out_file=str(b), block_variants=128
    )
    raw = b.read_bytes()
    assert raw[:4] == b"\x1f\x8b\x08\x04"  # gzip + FEXTRA (BGZF)
    assert raw.endswith(
        bytes.fromhex(
            "1f8b08040000000000ff0600424302001b0003000000000000000000"
        )
    )  # BGZF EOF marker
    assert gzip.decompress(raw) == a.read_bytes()
    assert res.bytes_written == len(raw)


def test_mesh_gz_index_view_roundtrip(fileset, tmp_path):
    """`filter --provider device -o out.vcf.gz --index` (CLI surface):
    the .tbi must round-trip region fetches through `view`."""
    import gzip

    from cli_helpers import run_cli
    from pgen_tpu.native import HAVE_NATIVE

    if not HAVE_NATIVE:
        pytest.skip("bgzf requires the native runtime")
    out = tmp_path / "m.vcf.gz"
    code = run_cli(
        [
            "filter", fileset, "--include-var", 'ALT == "G"',
            "--provider", "device", "-o", str(out), "--index",
        ]
    )
    assert code == 0
    assert (tmp_path / "m.vcf.gz.tbi").exists()
    ref = tmp_path / "r.vcf"
    filter_to_vcf(fileset, var_query='ALT == "G"', out_file=ref)
    assert gzip.decompress(out.read_bytes()) == ref.read_bytes()
    # indexed region fetch returns exactly the in-range body rows
    from pgen_tpu.formats.tabix import fetch_region

    want = [
        ln
        for ln in ref.read_text().splitlines()
        if not ln.startswith("#") and 100 <= int(ln.split("\t")[1]) <= 200
    ]
    # fetch_region takes 0-based half-open coords: POS in [100, 200]
    got = list(fetch_region(str(out), str(out) + ".tbi", "1", 99, 200))
    assert [g.decode().rstrip("\n") for g in got] == want


def test_graft_dryrun_drives_mesh_filter():
    """The driver's multichip dryrun must exercise the same end-to-end
    function the CLI calls."""
    import inspect

    import __graft_entry__ as g

    src = inspect.getsource(g.dryrun_multichip)
    assert "filter_to_vcf_mesh" in src


def test_mesh_zero_samples(tmp_path):
    """0-sample fileset: rec=0 makes every text shard zero-width, which
    degenerates array indices (all starts 0) — shard position must come
    from the device's mesh coordinate or all rows alias onto shard 0."""
    from conftest import build_fileset
    from oracle import scalar_filter_vcf

    codes = np.zeros((5, 0), dtype=np.uint8)
    p = build_fileset(
        tmp_path, "z", codes,
        [f"1\t{i + 1}\tv{i}\tA\tC\t.\t.\t." for i in range(5)], [],
    )
    out = tmp_path / "z.vcf"
    filter_to_vcf_mesh(p, out_file=out)
    assert out.read_bytes() == scalar_filter_vcf(p, None, None)


def test_mesh_empty_filter(tmp_path):
    from conftest import build_fileset
    from oracle import scalar_filter_vcf

    codes = np.ones((4, 3), dtype=np.uint8)
    p = build_fileset(
        tmp_path, "e", codes,
        [f"1\t{i + 1}\tv{i}\tA\tC\t.\t.\t." for i in range(4)],
        ["s0\tM", "s1\tF", "s2\tM"],
    )
    out = tmp_path / "e.vcf"
    filter_to_vcf_mesh(p, var_query='ALT=="Z"', out_file=out)
    assert out.read_bytes() == scalar_filter_vcf(p, lambda v: False, None)
