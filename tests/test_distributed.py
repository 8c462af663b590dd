"""Multi-process jax.distributed filtering (SURVEY.md §4: multi-host tests
must run without a pod — N local processes + a local coordinator)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from oracle import scalar_filter_vcf

REPO = Path(__file__).resolve().parent.parent

_WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
from pgen_tpu.parallel.distributed import run_distributed_filter
run_distributed_filter(
    {prefix!r},
    var_query={var_query!r},
    out_file={out!r},
    coordinator_address="localhost:{port}",
    num_processes={n},
    process_id=int(sys.argv[1]),
    shared_fs={shared_fs},
)
"""


def _launch(prefix, out, n, port, var_query=None, shared_fs=True):
    script = _WORKER.format(
        repo=str(REPO),
        prefix=prefix,
        var_query=var_query,
        out=str(out),
        port=port,
        n=n,
        shared_fs=shared_fs,
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            cwd=str(REPO),
        )
        for i in range(n)
    ]
    for p in procs:
        try:
            outb, errb = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, errb.decode()[-2000:]


@pytest.mark.slow
def test_two_process_shared_file(tiny_fileset, tmp_path):
    prefix, _ = tiny_fileset
    out = tmp_path / "dist.vcf"
    _launch(prefix, out, n=2, port=12399, var_query='REF == "A"')
    expected = scalar_filter_vcf(prefix, lambda v: v["REF"] == "A", None)
    assert out.read_bytes() == expected


@pytest.mark.slow
def test_two_process_standalone_shards_concatenate(tiny_fileset, tmp_path):
    prefix, _ = tiny_fileset
    out = tmp_path / "dist.vcf"
    _launch(prefix, out, n=2, port=12401, shared_fs=False)
    got = b"".join(
        (tmp_path / f"dist.vcf.shard{i}").read_bytes() for i in range(2)
    )
    assert got == scalar_filter_vcf(prefix, None, None)


_MESH_WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
jax.distributed.initialize(
    coordinator_address="localhost:{port}", num_processes=2, process_id=pid
)
import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from pgen_tpu.parallel.mesh import build_sharded_filter_step, make_mesh

assert jax.process_count() == 2
mesh = make_mesh(jax.devices())  # global mesh spanning both processes
ndev = len(jax.devices())
per = 8
nvar, rec = per * ndev, 3
rng = np.random.default_rng(0)
packed = rng.integers(0, 256, (nvar, rec), np.uint8)
mask = rng.random(nvar) < 0.5

from jax.experimental import multihost_utils
packed_g = multihost_utils.host_local_array_to_global_array(
    packed[pid * (nvar // 2) : (pid + 1) * (nvar // 2)], mesh, P("v", None)
)
mask_g = multihost_utils.host_local_array_to_global_array(
    mask[pid * (nvar // 2) : (pid + 1) * (nvar // 2)], mesh, P("v")
)
step = build_sharded_filter_step(mesh)
text, counts, offsets = step(packed_g, mask_g)
counts_local = np.asarray(counts.addressable_data(0))  # replicated output
exp = [int(mask[i * per : (i + 1) * per].sum()) for i in range(ndev)]
assert counts_local.tolist() == exp, (counts_local.tolist(), exp)
offs_local = np.asarray(offsets.addressable_data(0))
assert offs_local.tolist() == np.concatenate([[0], np.cumsum(exp)[:-1]]).tolist()
print("MESH_OK", pid)
"""


@pytest.mark.slow
def test_two_process_global_mesh_collectives(tmp_path):
    """2 processes x 2 local CPU devices form one 4-device variant mesh;
    the all-gather ordered-merge collective crosses the process boundary."""
    script = _MESH_WORKER.format(repo=str(REPO), port=12437)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            cwd=str(REPO),
        )
        for i in range(2)
    ]
    for p in procs:
        try:
            outb, errb = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, errb.decode()[-2500:]
        assert b"MESH_OK" in outb


_MESH_FILTER_WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
jax.distributed.initialize(
    coordinator_address="localhost:{port}", num_processes=2, process_id=pid
)
from pgen_tpu.parallel.mesh import make_mesh
from pgen_tpu.pipeline.mesh_filter import filter_to_vcf_mesh

mesh = make_mesh(jax.devices())  # 4-device mesh spanning both processes
res = filter_to_vcf_mesh(
    {prefix!r},
    var_query={var_query!r},
    out_file={out!r},
    mesh=mesh,
    block_variants=8,  # several blocks, so streaming + offsets are exercised
    index={index},
)
print("MESH_FILTER_OK", pid, res.num_variants_kept)
"""


@pytest.mark.slow
def test_two_process_mesh_filter_end_to_end(tiny_fileset, tmp_path):
    """The flagship multi-chip path across a PROCESS boundary: both
    processes run filter_to_vcf_mesh over one global 4-device mesh against
    the same shared-filesystem output; each pwrites only its addressable
    shards' rows and the result must be byte-identical to the oracle."""
    prefix, _ = tiny_fileset
    out = tmp_path / "meshdist.vcf"
    script = _MESH_FILTER_WORKER.format(
        repo=str(REPO),
        port=12461,
        prefix=prefix,
        var_query='REF == "A"',
        out=str(out),
        index=False,
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            cwd=str(REPO),
        )
        for i in range(2)
    ]
    for p in procs:
        try:
            outb, errb = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, errb.decode()[-2500:]
        assert b"MESH_FILTER_OK" in outb
    expected = scalar_filter_vcf(prefix, lambda v: v["REF"] == "A", None)
    assert out.read_bytes() == expected


@pytest.mark.slow
def test_two_process_mesh_filter_gz_parts_merge(tiny_fileset, tmp_path):
    """.gz across a PROCESS boundary: each process
    writes standalone per-(block, shard) BGZF parts, process 0 merges them
    in global order + EOF + tabix index; the merged stream must decompress
    byte-equal to the oracle and leave no part files behind."""
    import gzip

    from pgen_tpu.native import HAVE_NATIVE

    if not HAVE_NATIVE:
        pytest.skip("bgzf requires the native runtime")
    prefix, _ = tiny_fileset
    out = tmp_path / "meshdist.vcf.gz"
    script = _MESH_FILTER_WORKER.format(
        repo=str(REPO),
        port=12489,
        prefix=prefix,
        var_query='REF == "A"',
        out=str(out),
        index=True,
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            cwd=str(REPO),
        )
        for i in range(2)
    ]
    for p in procs:
        try:
            outb, errb = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, errb.decode()[-2500:]
        assert b"MESH_FILTER_OK" in outb
    expected = scalar_filter_vcf(prefix, lambda v: v["REF"] == "A", None)
    assert gzip.decompress(out.read_bytes()) == expected
    assert (tmp_path / "meshdist.vcf.gz.tbi").exists()
    assert not list(tmp_path.glob("*.part")), "part files not cleaned up"
