"""Variant-dimension sharding with an order-preserving merge.

The reference is strictly single-threaded (SURVEY.md §2 "Parallelism").
This engine shards the VARIANT axis — the long axis, up to ~10^6
rows for chr22 — across workers/hosts, per SURVEY.md §7 L4:

* metadata (.pvar/.psam) is small and loaded by every worker, so predicate
  masks, kept-row indices, and therefore every row's exact output byte
  offset are computed *deterministically everywhere*: the ordered merge
  needs no inter-host communication at all. (The generic design's
  all-gather-of-sizes collective degenerates to local arithmetic; the
  device-side collective path lives in parallel/mesh.py.)
* each worker gathers only its contiguous slice of kept variant records
  from the .pgen (its byte range ~ [12 + lo*rec, 12 + hi*rec)) and pwrites
  its rows at the precomputed offset of the shared output file — no host-0
  serialization, stable output order regardless of completion order
  (SURVEY.md §5 "Race detection": order stability is the tested invariant).

Single-process mode runs the shards sequentially (num_shards=N,
shard_index=None); a launcher runs one process per shard with
shard_index=i against the same out_file for true parallel writes.
"""

from __future__ import annotations

import json
import os

import numpy as np

from pgen_tpu.pipeline.filter import (
    BGZF_EOF,
    FilterResult,
    _emit_block_meta,
    _gather_rows,
    _pwrite_all,
    _resolve_provider,
    _write_all,
)
from pgen_tpu.pipeline.vcf import DEFAULT_SOURCE_TAG
from pgen_tpu.query.compile import compile_predicate
from pgen_tpu.utils.log import get_logger
from pgen_tpu.utils.timer import StageTimer

log = get_logger("shard")


def _mp_context():
    """Pick a safe multiprocessing start method.

    fork is fastest (no reimport cost) but forking a parent whose JAX
    runtime has already started threads can deadlock the child, so once
    jax is imported we switch to forkserver (the server process is forked
    clean, before any threads). PGEN_TPU_MP_CONTEXT overrides for tests.
    """
    import multiprocessing as mp
    import sys

    forced = os.environ.get("PGEN_TPU_MP_CONTEXT")
    if forced:
        return mp.get_context(forced)
    if "jax" in sys.modules:
        return mp.get_context("forkserver")
    return mp.get_context("fork")


def _worker_entry(result_q, index: int, kwargs: dict, inject_fail: bool = False) -> None:
    """Process entry point: run one shard, report its result on the queue.

    Returning counts from the worker lets the parent skip a second full
    predicate/GT pass over the data (the masks were already computed here).
    ``inject_fail`` is a test hook (PGEN_TPU_TEST_FAIL_SHARD, evaluated in
    the parent so it works under any start method).
    """
    if inject_fail:
        raise RuntimeError(f"injected failure for shard {index} (test hook)")
    res = filter_to_vcf_sharded(**kwargs)
    result_q.put(
        (
            index,
            res.num_variants_kept,
            res.num_samples_kept,
            res.bytes_written,
        )
    )


def _shard_part_path(out_file: str, index: int) -> str:
    return f"{out_file}.shard{index:04d}.part"


def _manifest_path(out_file: str) -> str:
    return f"{out_file}.manifest.json"


def _write_manifest(path: str, manifest: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, path)


def _concat_gz_parts(out_file: str, num_workers: int) -> int:
    """Concatenate standalone BGZF shard parts + EOF marker into out_file.

    BGZF members are independently decompressible, so byte concatenation
    of per-shard .gz streams is itself a valid BGZF file (SAM spec §4.1).
    """
    total = 0
    fd = os.open(out_file, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        for i in range(num_workers):
            part = _shard_part_path(out_file, i)
            with open(part, "rb") as f:
                while True:
                    chunk = f.read(8 << 20)
                    if not chunk:
                        break
                    _write_all(fd, memoryview(chunk))
                    total += len(chunk)
        _write_all(fd, memoryview(BGZF_EOF))
        total += len(BGZF_EOF)
    finally:
        os.close(fd)
    for i in range(num_workers):
        os.unlink(_shard_part_path(out_file, i))
    return total


def filter_to_vcf_parallel(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | None = None,
    provider: str = "auto",
    num_workers: int = 2,
    block_variants: int = 1 << 16,
    resume: bool = False,
    index: bool = False,
    index_format: str = "auto",
) -> FilterResult:
    """Run the shards in parallel worker processes, one shard each.

    For plain .vcf output the single-file ordered merge needs no
    coordination: every worker derives the same offsets and pwrites its own
    byte range. For .vcf.gz each worker writes a standalone BGZF stream
    (compressed sizes aren't precomputable) and the parent concatenates the
    parts in shard order — BGZF members concatenate losslessly.

    A JSON manifest ({out}.manifest.json) tracks per-shard status; if some
    workers fail, rerunning with ``resume=True`` re-executes only the
    shards not marked done and completes the identical file. The manifest
    is removed on success. This is the single-host stand-in for the
    multi-host deployment (one process per host).
    """
    if num_workers <= 1:
        return filter_to_vcf_sharded(
            pfile_prefix,
            var_query=var_query,
            sam_query=sam_query,
            out_file=out_file,
            provider=provider,
            num_shards=1,
            block_variants=block_variants,
            index=index,
            index_format=index_format,
        )
    if index and not str(out_file or f"{pfile_prefix}.pgen-rs.vcf").endswith(".gz"):
        raise ValueError("--index requires a .gz (BGZF) output file")
    if out_file is None:
        out_file = f"{pfile_prefix}.pgen-rs.vcf"
    out_file = str(out_file)
    gz = out_file.endswith(".gz")

    mpath = _manifest_path(out_file)
    params = {
        "pfile_prefix": str(pfile_prefix),
        "var_query": var_query,
        "sam_query": sam_query,
        "num_workers": num_workers,
        "gz": gz,
    }
    if resume and os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
        if manifest.get("params") != params:
            raise ValueError(
                f"{mpath} was written for different parameters; rerun "
                "without resume (or delete the manifest)"
            )
    else:
        manifest = {
            "version": 1,
            "params": params,
            "shards": [
                {"index": i, "status": "pending"} for i in range(num_workers)
            ],
        }
    _write_manifest(mpath, manifest)

    pending = [s["index"] for s in manifest["shards"] if s["status"] != "done"]
    ctx = _mp_context()
    result_q = ctx.Queue()
    procs = {}
    for i in pending:
        p = ctx.Process(
            target=_worker_entry,
            args=(
                result_q,
                i,
                dict(
                    pfile_prefix=pfile_prefix,
                    var_query=var_query,
                    sam_query=sam_query,
                    out_file=_shard_part_path(out_file, i) if gz else out_file,
                    provider=provider,
                    num_shards=num_workers,
                    shard_index=i,
                    block_variants=block_variants,
                    standalone=gz,
                    gz=gz,
                ),
                os.environ.get("PGEN_TPU_TEST_FAIL_SHARD") == str(i),
            ),
        )
        p.start()
        procs[i] = p

    # Drain results as workers finish so done shards are checkpointed even
    # if a sibling later fails (a dead worker never reports, so poll
    # liveness instead of blocking on a fixed result count).
    import queue as queue_mod

    results = {}

    def _record(item):
        idx, nv, ns, nbytes = item
        results[idx] = (nv, ns, nbytes)
        shard = manifest["shards"][idx]
        shard["status"] = "done"
        shard["bytes_written"] = nbytes
        shard["variants_kept"] = nv
        shard["samples_kept"] = ns
        _write_manifest(mpath, manifest)

    alive = set(procs)
    while alive:
        try:
            _record(result_q.get(timeout=0.1))
        except queue_mod.Empty:
            pass
        for i in list(alive):
            if not procs[i].is_alive():
                procs[i].join()
                alive.discard(i)
    # Results can trail the process exit: a clean worker flushes its queue
    # payload before exiting, but the parent may see the pipe readable only
    # after is_alive() already went false — one Empty window would then
    # mis-mark a finished shard as failed. Keep draining until every
    # zero-exit worker has reported (bounded, in case one exited 0 without
    # ever reporting).
    import time as time_mod

    deadline = time_mod.monotonic() + 10.0
    while (
        any(p.exitcode == 0 and i not in results for i, p in procs.items())
        and time_mod.monotonic() < deadline
    ):
        try:
            _record(result_q.get(timeout=0.2))
        except queue_mod.Empty:
            pass
    while True:  # final sweep of anything else buffered
        try:
            _record(result_q.get_nowait())
        except queue_mod.Empty:
            break

    failed = []
    for i, p in procs.items():
        p.join()
        if p.exitcode != 0 or i not in results:
            failed.append((i, p.exitcode))
            manifest["shards"][i]["status"] = "failed"
    if failed:
        _write_manifest(mpath, manifest)
        raise RuntimeError(
            f"shard workers failed: {failed}; completed shards are recorded "
            f"in {mpath} — rerun with resume=True (--resume) to finish"
        )

    done = [s for s in manifest["shards"] if s["status"] == "done"]
    # Shard counts: every worker computes the same global masks, so any
    # reporter's kept counts are authoritative; bytes sum over shards.
    nv = max((s["variants_kept"] for s in done), default=0)
    ns = max((s["samples_kept"] for s in done), default=0)
    if gz:
        parts = [_shard_part_path(out_file, i) for i in range(num_workers)]
        if all(os.path.exists(p) for p in parts):
            bytes_written = _concat_gz_parts(out_file, num_workers)
        elif os.path.exists(out_file) and not any(os.path.exists(p) for p in parts):
            # resume after a crash in the concat..manifest-unlink window:
            # the merge already completed (parts are consumed atomically
            # after the full write), so the file is the finished output
            bytes_written = os.path.getsize(out_file)
        else:
            raise RuntimeError(
                f"{out_file}: shard parts are incomplete but the manifest "
                "says all shards are done; delete the manifest and rerun"
            )
    else:
        bytes_written = os.path.getsize(out_file)
    # The filter itself is complete: drop the manifest BEFORE indexing so
    # an index failure (e.g. non-integer POS) can't strand an all-done
    # manifest whose parts were already consumed by the merge.
    os.unlink(mpath)
    if index:
        # The merged file is a complete BGZF stream; the parent re-derives
        # the row layout (one metadata predicate pass — a second genotype
        # pass only for GT_* queries) and indexes it.
        _index_merged_gz(
            out_file, pfile_prefix, var_query, sam_query, provider, index_format
        )
    return FilterResult(
        out_path=out_file,
        num_variants_kept=nv,
        num_samples_kept=ns,
        bytes_written=bytes_written,
        timer=StageTimer(),
    )


def _index_merged_gz(
    gz_path: str,
    pfile_prefix: str,
    var_query,
    sam_query,
    provider: str,
    index_format: str,
) -> str:
    """Index a merged sharded .vcf.gz: re-derive the deterministic row
    layout (the same arithmetic every worker used) and emit .tbi/.csi."""
    from pgen_tpu.pipeline.filter import derive_row_layout, emit_tabix_index

    lay = derive_row_layout(pfile_prefix, var_query, sam_query, provider)
    return emit_tabix_index(
        gz_path,
        lay.pvar,
        lay.var_idx,
        lay.prefix_sizes,
        lay.row_fixed,
        len(lay.header_bytes),
        fmt=index_format,
    )


def plan_shards(num_kept: int, num_shards: int) -> list:
    """Contiguous, balanced partition of kept-variant positions.

    Returns [(lo, hi)] with lo/hi indices into the kept-variant list; shard
    sizes differ by at most 1. Contiguity keeps each shard's .pgen reads a
    single byte range and the output merge order-preserving by construction.
    """
    bounds = [(num_kept * i) // num_shards for i in range(num_shards + 1)]
    return [(bounds[i], bounds[i + 1]) for i in range(num_shards)]


def filter_to_vcf_sharded(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | None = None,
    provider: str = "auto",
    num_shards: int = 1,
    shard_index: int | None = None,
    block_variants: int = 1 << 16,
    source_tag: str = DEFAULT_SOURCE_TAG,
    standalone: bool = False,
    gz: bool | None = None,
    index: bool = False,
    index_format: str = "auto",
) -> FilterResult:
    """Shard the kept variants over ``num_shards`` workers writing one VCF.

    With shard_index=None all shards run in this process (sequentially);
    otherwise only that shard's rows are written (plus the header, by shard
    0) into the common preallocated output file. With standalone=True the
    shard writes its own bytes from offset 0 of its own file (no shared
    filesystem; files concatenate to the full VCF in shard order).

    BGZF output (``gz=True``, default inferred from the .gz suffix) is
    supported sequentially (shard_index=None: blocks stream-compress in
    order, EOF appended) and standalone (each shard emits its own BGZF
    stream, no EOF — the concatenating caller appends it). The shared-file
    pwrite mode can't compress (offsets aren't precomputable).
    """
    provider = _resolve_provider(provider)
    timer = StageTimer()
    if out_file is None:
        out_file = f"{pfile_prefix}.pgen-rs.vcf"
    out_file = str(out_file)
    if gz is None:
        gz = out_file.endswith(".gz")
    if gz and shard_index is not None and not standalone:
        raise ValueError(
            "bgzf (.gz) output cannot target a shared sharded file "
            "(compressed offsets aren't precomputable); use "
            "filter_to_vcf_parallel (standalone parts) or a single shard"
        )
    if index and (not gz or shard_index is not None):
        raise ValueError(
            "--index with shards requires a complete .gz file "
            "(run all shards in one process, or use --workers)"
        )

    from pgen_tpu.pipeline.filter import derive_row_layout

    lay = derive_row_layout(
        pfile_prefix, var_query, sam_query, provider, source_tag, timer
    )
    pvar, records = lay.pvar, lay.records
    rec = lay.header.record_size
    var_idx, sample_idx_arg = lay.var_idx, lay.sample_idx_arg
    n_kept = len(lay.sam_idx)
    header_bytes, v_starts, v_ends = lay.header_bytes, lay.v_starts, lay.v_ends
    prefix_sizes, row_fixed, total = lay.prefix_sizes, lay.row_fixed, lay.total

    # Every worker derives the same shard plan and byte offsets — the
    # order-preserving merge is pure arithmetic.
    shards = plan_shards(len(var_idx), num_shards)

    def shard_byte_start(lo: int) -> int:
        # bytes of all rows before kept-position lo
        return len(header_bytes) + int(prefix_sizes[lo]) + lo * row_fixed

    # Byte base: 0 for the shared file; the shard's own start offset when
    # writing a standalone per-shard file (header only in shard 0's file).
    base = 0
    local_total = total
    if standalone:
        if shard_index is None:
            raise ValueError("standalone mode needs an explicit shard_index")
        s_lo, s_hi = plan_shards(len(var_idx), num_shards)[shard_index]
        base = len(header_bytes) + int(prefix_sizes[s_lo]) + s_lo * row_fixed
        if shard_index == 0:
            base = 0  # shard 0's standalone file carries the header
        local_total = (
            len(header_bytes) + int(prefix_sizes[s_hi]) + s_hi * row_fixed
        ) - base

    my_shards = range(num_shards) if shard_index is None else [shard_index]
    emits_header = shard_index is None or shard_index == 0

    if gz:
        from pgen_tpu.native import HAVE_NATIVE, native

        if not HAVE_NATIVE:
            raise RuntimeError(
                "bgzf (.gz) output requires the native runtime (C++ toolchain)"
            )
        # Compressed sizes are unknowable up front: stream-append BGZF
        # members in shard order instead of pwriting at fixed offsets.
        fd = os.open(out_file, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        written = 0
        try:
            if emits_header:
                comp = native.bgzf_compress(
                    np.frombuffer(header_bytes, dtype=np.uint8)
                )
                _write_all(fd, memoryview(comp))
                written += len(comp)
            scratch = None  # reused across blocks: fresh per-block buffers
            # would pay first-touch page backing for the WHOLE output
            for si in my_shards:
                lo, hi = shards[si]
                for blo in range(lo, hi, block_variants):
                    bhi = min(blo + block_variants, hi)
                    idx_blk = var_idx[blo:bhi]
                    with timer.stage("gather", nbytes=int(len(idx_blk) * rec)):
                        packed_blk = _gather_rows(records, idx_blk)
                    cap = (
                        int(prefix_sizes[bhi] - prefix_sizes[blo])
                        + len(idx_blk) * row_fixed
                    )
                    if scratch is None or scratch.nbytes < cap:
                        scratch = np.empty(cap, dtype=np.uint8)
                    with timer.stage("emit", nbytes=cap):
                        n = _emit_block_meta(
                            provider,
                            packed_blk,
                            pvar.data_buffer,
                            v_starts[blo:bhi],
                            v_ends[blo:bhi],
                            sample_idx_arg,
                            n_kept,
                            scratch,
                        )
                    with timer.stage("compress", nbytes=n):
                        comp = native.bgzf_compress(scratch[:n])
                    with timer.stage("write", nbytes=len(comp)):
                        _write_all(fd, memoryview(comp))
                    written += len(comp)
            if shard_index is None:
                # sequential mode produces the complete file: finish it
                _write_all(fd, memoryview(BGZF_EOF))
                written += len(BGZF_EOF)
        finally:
            os.close(fd)
        if index:
            from pgen_tpu.pipeline.filter import emit_tabix_index

            with timer.stage("index"):
                emit_tabix_index(
                    out_file,
                    pvar,
                    var_idx,
                    prefix_sizes,
                    row_fixed,
                    len(header_bytes),
                    fmt=index_format,
                )
        return FilterResult(
            out_path=out_file,
            num_variants_kept=len(var_idx),
            num_samples_kept=n_kept,
            bytes_written=written,
            timer=timer,
        )

    # mmap emission, exactly like the single-process path: every block's
    # output offset is known up front, so blocks format DIRECTLY into the
    # mapped file — no scratch buffer + pwrite double-copy (which measured
    # ~2x slower per shard and sank the bench's 2-host projection). In
    # shared-file mode each worker maps the same file and writes disjoint
    # ranges; ftruncate only when the size differs so an existing
    # same-size output keeps its backed pages (warm-run page reuse).
    import mmap as mmap_mod

    fd = os.open(out_file, os.O_RDWR | os.O_CREAT, 0o644)
    written = 0
    try:
        if os.fstat(fd).st_size != local_total:
            os.ftruncate(fd, local_total)
        if local_total > 0:
            mm = mmap_mod.mmap(fd, local_total)
            out_arr = np.frombuffer(mm, dtype=np.uint8)
            try:
                if emits_header:
                    out_arr[: len(header_bytes)] = np.frombuffer(
                        header_bytes, dtype=np.uint8
                    )
                    written += len(header_bytes)
                blocks = []
                for si in my_shards:
                    lo, hi = shards[si]
                    pos = shard_byte_start(lo) - base
                    for blo in range(lo, hi, block_variants):
                        bhi = min(blo + block_variants, hi)
                        cap = int(
                            prefix_sizes[bhi] - prefix_sizes[blo]
                        ) + (bhi - blo) * row_fixed
                        blocks.append((blo, bhi, pos, cap))
                        pos += cap
                    assert pos == shard_byte_start(hi) - base, (
                        "shard offset accounting bug"
                    )

                def emit_one(args):
                    blo, bhi, bpos, cap = args
                    packed_blk = _gather_rows(records, var_idx[blo:bhi])
                    return _emit_block_meta(
                        provider,
                        packed_blk,
                        pvar.data_buffer,
                        v_starts[blo:bhi],
                        v_ends[blo:bhi],
                        sample_idx_arg,
                        n_kept,
                        out_arr[bpos : bpos + cap],
                    )

                nbytes_body = sum(c for _, _, _, c in blocks)
                nthreads = (
                    min(2, os.cpu_count() or 1) if provider == "native" else 1
                )
                with timer.stage("emit", nbytes=nbytes_body):
                    if nthreads > 1 and len(blocks) > 1:
                        from concurrent.futures import ThreadPoolExecutor

                        with ThreadPoolExecutor(max_workers=nthreads) as ex:
                            ns = list(ex.map(emit_one, blocks))
                    else:
                        ns = [emit_one(b) for b in blocks]
                for (blo, bhi, bpos, cap), n in zip(blocks, ns):
                    assert n == cap, (
                        f"block [{blo},{bhi}) wrote {n}, expected {cap}"
                    )
                written += nbytes_body
            finally:
                out_arr = None
                try:
                    mm.close()
                except BufferError:
                    # an in-flight exception's traceback can pin a view of
                    # the mapping; let the original error propagate (the
                    # mapping is released when the frames are collected)
                    pass
    finally:
        os.close(fd)

    return FilterResult(
        out_path=out_file,
        num_variants_kept=len(var_idx),
        num_samples_kept=n_kept,
        bytes_written=written,  # header already counted when emitted
        timer=timer,
    )
