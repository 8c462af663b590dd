"""Multi-host deployment glue: jax.distributed + per-host shard filtering.

SURVEY.md §5 "Distributed communication backend": the reference is one
process; the design runs one process per host, each owning a
contiguous variant-range shard. Control-plane setup is jax.distributed
(coordinator rendezvous); the data plane needs NO communication for the
ordered merge (offsets derive from metadata everywhere — parallel/shard.py)
— collectives appear only in the on-device mesh step (parallel/mesh.py),
running on the device mesh.

Two deployment modes:

* shared filesystem: every host pwrites its shard into one output file at
  its precomputed offset (`run_distributed_filter`).
* no shared fs: each host writes `{out}.shard{i}`; host 0 concatenates (or
  the shards are served as-is — VCF bodies concatenate trivially).

Testable without a pod: N local processes, CPU platform, local coordinator
(tests/test_distributed.py) — the jax.distributed path is identical.
"""

from __future__ import annotations

import os

from pgen_tpu.parallel.shard import filter_to_vcf_sharded
from pgen_tpu.utils.log import get_logger

log = get_logger("distributed")


def initialize_from_env(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple:
    """Initialize jax.distributed; returns (process_id, num_processes).

    Arguments default to JAX's env autodetection or the
    PGEN_TPU_COORDINATOR / PGEN_TPU_NUM_PROCS / PGEN_TPU_PROC_ID vars.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get("PGEN_TPU_COORDINATOR")
    if num_processes is None and "PGEN_TPU_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["PGEN_TPU_NUM_PROCS"])
    if process_id is None and "PGEN_TPU_PROC_ID" in os.environ:
        process_id = int(os.environ["PGEN_TPU_PROC_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_index(), jax.process_count()


def run_distributed_filter(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | None = None,
    provider: str = "auto",
    block_variants: int = 1 << 16,
    shared_fs: bool = True,
    **init_kwargs,
):
    """Each process filters its variant shard; output order is stable.

    Call once per host/process. With shared_fs, all processes write the
    same file (pwrite at deterministic offsets); otherwise each writes
    `{out}.shard{pid}` and process 0's return names the pieces.
    """
    pid, nprocs = initialize_from_env(**init_kwargs)
    log.info("distributed filter: process %d/%d", pid, nprocs)
    if out_file is None:
        out_file = f"{pfile_prefix}.pgen-rs.vcf"
    target = str(out_file) if shared_fs else f"{out_file}.shard{pid}"
    result = filter_to_vcf_sharded(
        pfile_prefix,
        var_query=var_query,
        sam_query=sam_query,
        out_file=target,
        provider=provider,
        num_shards=nprocs,
        shard_index=pid,
        block_variants=block_variants,
        standalone=not shared_fs,
    )
    # barrier so no process exits before the file is complete everywhere
    _barrier()
    return result


def _barrier():
    import jax

    if jax.process_count() == 1:
        return
    # tiny global psum as a barrier over DCN/ICI
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("pgen_tpu_filter_done")
