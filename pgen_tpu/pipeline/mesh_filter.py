"""End-to-end device-mesh filter: the flagship multi-chip path.

This is the device-mesh rendering of the reference's `filter` flagship call
stack (/root/reference/src/pfile.rs:104-194) over a `jax.sharding.Mesh`
(SURVEY.md §7 L4). Per variant block:

    host: pad block to the mesh size, hand sharded tensors to ONE jitted
          step (jit in_shardings place each host array on its shard)
    device (per shard): predicate mask (device-lowered expression over
          padded column tensors, or a host-computed mask for expressions
          outside the device subset) -> stable kept-first compaction
          (skipped when the host pre-gathered kept rows) -> four GT text
          planes, elementwise from the packed bytes
    collective: all_gather of per-shard kept counts -> every
          shard's global output row offset (the ordered merge is pure
          arithmetic; genotype text never crosses chips)
    host: each process reads back only its addressable shards' kept rows
          and pwrites them at their derived byte offsets (variable-length
          pvar prefixes stay host-side, SURVEY.md §7 "hard parts" #3)

Output is byte-identical to the host providers (tests assert it); the
multi-chip dryrun (__graft_entry__.dryrun_multichip) drives THIS function,
the same one `pgen-tpu filter --provider device` calls.
"""

from __future__ import annotations

import os

import numpy as np

from pgen_tpu.formats.header import read_pgen_header
from pgen_tpu.formats.metadata import read_metadata
from pgen_tpu.pipeline.filter import (
    DEFAULT_BLOCK_VARIANTS,
    FilterResult,
    _pwrite_all,
    compute_masks,
    materialize_prefixes,
)
from pgen_tpu.pipeline.vcf import DEFAULT_SOURCE_TAG, vcf_header_bytes
from pgen_tpu.query.compile import compile_predicate
from pgen_tpu.utils.log import get_logger
from pgen_tpu.utils.timer import StageTimer

log = get_logger("mesh_filter")


def _device_expr_columns(var_node, pvar):
    """Padded column tensors for a device-lowerable variant expression.

    Returns {name: (mat, lens)} over ALL pvar rows, or None when the
    expression references anything outside the device subset (virtual
    INFO_* columns, GT_* stats, builtins) — the caller then computes the
    mask on host instead.
    """
    from pgen_tpu.query.ast import variables

    if var_node is None:
        return None
    names = variables(var_node)
    cols = {}
    for name in names:
        if name not in pvar.columns:
            return None  # virtual/extension variable: host mask path
        mat, lens = pvar.get_column_padded(name)
        cols[name] = (mat, np.asarray(lens, dtype=np.int32))
    return cols if cols else None


def filter_to_vcf_mesh(
    pfile_prefix: str,
    var_query: str | None = None,
    sam_query: str | None = None,
    out_file: str | None = None,
    mesh=None,
    block_variants: int = DEFAULT_BLOCK_VARIANTS,
    source_tag: str = DEFAULT_SOURCE_TAG,
    index: bool = False,
    index_format: str = "auto",
) -> FilterResult:
    """Filter a pgen fileset to a VCF with the device-mesh pipeline.

    mesh defaults to a 1-D mesh over all local devices. Works on any mesh
    size >= 1; on a multi-host deployment each process writes only its
    addressable shards (the byte offsets are derived from the replicated
    all-gathered counts, so no host coordinates with any other).

    A ``.gz`` out_file produces BGZF (bcftools/tabix compatible): each
    drained (block, shard) chunk compresses into standalone BGZF members.
    Single-process runs stream-append them in drain order; multi-process
    deployments write per-chunk part files and process 0 concatenates them
    in global (block, shard) order — BGZF members concatenate losslessly,
    exactly like the host shard path (parallel/shard.py _concat_gz_parts).
    ``index=True`` additionally emits a tabix .tbi/.csi from the same
    arithmetic row layout the uncompressed path uses (every row's
    uncompressed offset is known without re-reading the output).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pgen_tpu.parallel.mesh import (
        VARIANT_AXIS,
        build_mesh_pipeline_step,
        make_mesh,
    )
    from pgen_tpu.pipeline.device import device_backend
    from pgen_tpu.query.compile_device import DeviceFallback
    from pgen_tpu.query.parser import parse

    device_backend()
    timer = StageTimer()
    if mesh is None:
        mesh = make_mesh()
    ndev = int(mesh.devices.size)
    if out_file is None:
        out_file = f"{pfile_prefix}.pgen-rs.vcf"
    out_file = str(out_file)
    gz = out_file.endswith(".gz")
    if gz:
        from pgen_tpu.native import HAVE_NATIVE as _have_native

        if not _have_native:
            raise ValueError(
                "bgzf (.gz) output requires the native runtime (C++ toolchain)"
            )
    if index and not gz:
        raise ValueError("--index requires a .gz (BGZF) output file")

    with timer.stage("metadata_load"):
        header = read_pgen_header(f"{pfile_prefix}.pgen")
        pvar = read_metadata(f"{pfile_prefix}.pvar")
        psam = read_metadata(f"{pfile_prefix}.psam")
    psam.column_index("IID")

    rec = header.record_size
    pgen_mm = np.memmap(f"{pfile_prefix}.pgen", dtype=np.uint8, mode="r")
    expected = 12 + header.num_variants * rec
    if pgen_mm.shape[0] < expected:
        raise ValueError(
            f"{pfile_prefix}.pgen is {pgen_mm.shape[0]} bytes; header "
            f"implies {expected}"
        )
    records = pgen_mm[12:expected].reshape(header.num_variants, rec)

    var_node = parse(var_query) if isinstance(var_query, str) else var_query

    # Sample predicate: psam is small — host evaluation, exactly like the
    # single-chip path; the kept-sample gather happens on device.
    with timer.stage("predicates"):
        cols = _device_expr_columns(var_node, pvar)
        # a sample query with GT_* variables (e.g. --mind sugar) needs the
        # per-sample histogram binding compute_masks provides: host masks
        if isinstance(sam_query, str) and cols is not None:
            from pgen_tpu.ops.gt_stats import GT_VARIABLE_NAMES
            from pgen_tpu.query.ast import variables as _variables

            sam_node_probe = parse(sam_query)
            if _variables(sam_node_probe) & set(GT_VARIABLE_NAMES):
                cols = None
        host_var_mask = None
        if cols is None:
            # outside the device expression subset (or no query): compute
            # the variant mask on host and shard it as a step input
            host_var_mask, sam_mask = compute_masks(
                var_node, sam_query, pvar, psam, header, records, "device"
            )
        else:
            sam_mask = compile_predicate(sam_query, psam)
    sam_idx = np.flatnonzero(sam_mask)
    all_iids = psam.get_column_strs("IID")
    sample_ids = [all_iids[i] for i in sam_idx]
    n_kept = len(sam_idx)
    keep_all = n_kept == psam.num_rows == header.num_samples
    sample_sel = None if keep_all else sam_idx.astype(np.int32)

    if len(sam_idx) and int(sam_idx[-1]) // 4 >= rec:
        raise ValueError(
            f"{pfile_prefix}.psam row {int(sam_idx[-1])} is beyond the "
            f"pgen's {header.num_samples}-sample records"
        )

    header_bytes = vcf_header_bytes(pvar, sample_ids, source_tag)
    line_starts_all, line_ends_all = pvar.row_line_spans()
    nvar_meta = pvar.num_rows
    if nvar_meta > header.num_variants:
        raise ValueError(
            f"{pfile_prefix}.pvar row {header.num_variants} is beyond the "
            f"pgen's {header.num_variants} variant records"
        )
    row_fixed = 4 * n_kept + 1

    # Host-known mask (no query, or an expression outside the device
    # subset): pre-gather ONLY the kept rows into the blocks. h2d traffic
    # then scales with kept rows, every block ships full, and the mask is
    # a prefix-run of ones per shard so the step skips the on-device
    # argsort+gather compaction (precompacted=True).
    if cols is None:
        universe = np.flatnonzero(host_var_mask)
        precompacted = True
    else:
        universe = None  # device-evaluated predicate: all rows ship
        precompacted = False
    total_rows = len(universe) if universe is not None else nvar_meta

    # Fixed block geometry: every block is padded to the same sharded shape
    # so ONE compiled step serves all blocks.
    vb = min(block_variants, max(total_rows, 1))
    vb += (-vb) % ndev
    # Pad the record dimension (R = ceil(2S/8)) to a 128-byte multiple; the
    # pad bytes decode to "\t0/0" text that the drain slice discards.
    # Whether the pad pays on the GPU is not measured yet.
    rec_pad = rec + (-rec) % 128

    # Plane-form step for ALL runs: four dense (v, R) u32 text planes in
    # place of the interleaved (v, 4R) tensor (see parallel/mesh.py
    # _local_pipeline_planes). The host assembler
    # interleaves planes while copying rows; sample subsets become a
    # per-kept-sample gather there (planes[s%4][s//4]) instead of an
    # on-device column gather.
    step = build_mesh_pipeline_step(
        mesh,
        None if cols is None else var_node,
        precompacted=precompacted,
        planes=True,
    )
    shard_2d = NamedSharding(mesh, P(VARIANT_AXIS, None))
    shard_1d = NamedSharding(mesh, P(VARIANT_AXIS))

    from collections import deque

    from pgen_tpu.native import HAVE_NATIVE

    if HAVE_NATIVE:
        from pgen_tpu.native import native

    n_text_cols = 4 * n_kept  # bytes of GT text per row
    if sample_sel is not None:
        # Sample-subset readback: gather each kept sample's text word ON
        # DEVICE before the host fetch (plane s%4, lane s//4), so d2h
        # ships 4*n_kept B/row instead of the full-width plane set.
        # Precompute per-plane lane lists + the column order that restores
        # kept-sample order after per-plane concatenation.
        _sel_div = (sample_sel // 4).astype(np.int64)
        _sel_mod = sample_sel % 4
        _plane_kept = [np.flatnonzero(_sel_mod == k) for k in range(4)]
        plane_gather = [_sel_div[p] for p in _plane_kept]
        subset_col_order = np.argsort(
            np.concatenate(_plane_kept), kind="stable"
        )
    per = vb // ndev
    # Shard position from the DEVICE's mesh coordinate, not the array
    # index: zero-width arrays (0 samples) degenerate every shard's
    # index to start 0, which would alias all shards onto d=0.
    dev_to_d = {dev.id: i for i, dev in enumerate(mesh.devices.flat)}

    nproc = jax.process_count()
    pid = jax.process_index()
    if gz:
        from pgen_tpu.native import native as _native

        from pgen_tpu.pipeline.filter import _write_all

        # Compressed sizes aren't precomputable, so .gz can't pwrite at
        # arithmetic offsets. Single-process: stream-append BGZF members in
        # drain order (== global row order). Multi-process: per-(block,
        # shard) standalone part files, merged by process 0 below.
        if nproc == 1:
            fd = os.open(out_file, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        else:
            fd = -1
    else:
        # No O_TRUNC: on a multi-process deployment every process opens the
        # SAME shared-filesystem output and pwrites its own shards' rows —
        # a late opener must not wipe an early writer's bytes. The final
        # size is set by the ftruncate below (identical in every process:
        # the byte accounting is derived from the replicated counts).
        fd = os.open(out_file, os.O_WRONLY | os.O_CREAT, 0o644)
    state = {"byte_base": len(header_bytes), "rows": 0, "gz_bytes": 0}
    # Tabix layout accumulation: the drained mask/counts are replicated, so
    # EVERY process sees the full kept set — the index row spans need no
    # extra collective.
    kept_rows: list = []
    kept_ls: list = []
    kept_le: list = []

    def _gz_part_path(bi: int, d: int) -> str:
        return f"{out_file}.mesh.b{bi:06d}.d{d:04d}.part"

    def drain(block):
        """Read back one block's shards and write their rows.

        Each process handles only its addressable shards; the byte offsets
        come from the replicated all-gathered counts, so no coordination.
        """
        bi, n, rows_blk, ls_blk, le_blk, text_out, mask, counts = block
        counts_h = np.asarray(counts)
        offs_h = np.concatenate(([0], np.cumsum(counts_h)[:-1]))
        mask_h = np.asarray(mask)[:n]
        kept_local = np.flatnonzero(mask_h)
        nk = len(kept_local)
        ls = ls_blk[kept_local]
        le = le_blk[kept_local]
        if index:
            kept_rows.append(rows_blk[kept_local])
            kept_ls.append(ls)
            kept_le.append(le)
        psz = np.zeros(nk + 1, dtype=np.int64)
        np.cumsum(le - ls + 3, out=psz[1:])
        # align the four planes' addressable shards by device
        shard_maps = [
            {dev_to_d[s.device.id]: s for s in p.addressable_shards}
            for p in text_out
        ]
        for d in sorted(shard_maps[0]):
            shard = [shard_maps[k][d] for k in range(4)]
            c = int(counts_h[d])
            if c == 0:
                continue
            k0 = int(offs_h[d])  # kept-row offset within the block
            bstart = state["byte_base"] + int(psz[k0]) + k0 * row_fixed
            nbytes = int(psz[k0 + c] - psz[k0]) + c * row_fixed
            pbuf, poff = materialize_prefixes(pvar.data_buffer, ls[k0 : k0 + c], le[k0 : k0 + c])
            scratch = np.empty(nbytes, dtype=np.uint8)
            if sample_sel is None:
                with timer.stage("fetch", nbytes=c * n_text_cols):
                    # slice the kept rows ON DEVICE (shard.data[:c]) so
                    # only them cross to the host
                    plane_data = [
                        np.ascontiguousarray(np.asarray(s.data[:c]))
                        for s in shard
                    ]
                with timer.stage("assemble", nbytes=nbytes):
                    if HAVE_NATIVE:
                        n = native.assemble_rows_planes(
                            plane_data, n_text_cols, pbuf, poff, scratch
                        )
                    else:
                        from pgen_tpu.ops.gt_text import interleave_planes_numpy
                        from pgen_tpu.pipeline.filter import _assemble_rows_numpy

                        text_u8 = interleave_planes_numpy(plane_data, n_text_cols)
                        n = _assemble_rows_numpy(text_u8, pbuf, poff, scratch)
            else:
                with timer.stage("fetch", nbytes=c * n_text_cols):
                    # kept rows AND kept sample lanes sliced on device
                    parts = [
                        np.asarray(shard[k].data[:c][:, plane_gather[k]])
                        for k in range(4)
                        if len(plane_gather[k])
                    ]
                    words = (
                        np.ascontiguousarray(
                            np.concatenate(parts, axis=1)[:, subset_col_order]
                        )
                        if parts
                        else np.zeros((c, 0), dtype=np.uint32)
                    )
                text_u8 = words.view(np.uint8).reshape(c, -1)
                with timer.stage("assemble", nbytes=nbytes):
                    if HAVE_NATIVE:
                        n = native.assemble_rows_buf(text_u8, pbuf, poff, scratch)
                    else:
                        from pgen_tpu.pipeline.filter import _assemble_rows_numpy

                        n = _assemble_rows_numpy(text_u8, pbuf, poff, scratch)
            assert n == nbytes, f"mesh shard wrote {n}, planned {nbytes}"
            if gz:
                with timer.stage("compress", nbytes=nbytes):
                    comp = _native.bgzf_compress(scratch)
                with timer.stage("pwrite", nbytes=len(comp)):
                    if nproc == 1:
                        _write_all(fd, memoryview(comp))
                    else:
                        part = _gz_part_path(bi, d)
                        with open(part + ".tmp", "wb") as pf:
                            pf.write(comp)
                        os.replace(part + ".tmp", part)
                state["gz_bytes"] += len(comp)
            else:
                with timer.stage("pwrite", nbytes=nbytes):
                    _pwrite_all(fd, scratch, bstart)
        state["byte_base"] += int(psz[-1]) + nk * row_fixed
        state["rows"] += nk

    # Double-buffered staging (SURVEY.md §2 "I/O parallelism"): a reader
    # thread faults in and pads block i+1's host arrays (the page-cache
    # read is the slow host half on cold files) while the main thread
    # ships block i to the devices and drains block i-1's output.
    from concurrent.futures import ThreadPoolExecutor

    def stage_block(lo: int):
        hi = min(lo + vb, total_rows)
        n = hi - lo
        packed = np.zeros((vb, rec_pad), dtype=np.uint8)
        valid = np.zeros(vb, dtype=bool)
        valid[:n] = True
        if universe is not None:
            rows = universe[lo:hi]
            packed[:n, :rec] = records[rows]  # host gather: only kept rows ship
            host_pred = valid  # prefix-ones: mask == valid on device
        else:
            rows = np.arange(lo, hi)
            packed[:n, :rec] = records[lo:hi]
            if host_var_mask is not None:  # post-fallback blocks
                pred = np.zeros(vb, dtype=bool)
                pred[:n] = host_var_mask[lo:hi]
                host_pred = pred
            else:
                host_pred = None
        return lo, hi, n, packed, valid, host_pred, rows, line_starts_all[rows], line_ends_all[rows]

    reader = ThreadPoolExecutor(1, thread_name_prefix="pgen-stage")

    # Streamed: dispatch block i+1 while block i drains (dispatch is
    # async, so the device computes ahead of the host readback/write).
    pending = deque()
    try:
        if gz:
            if nproc == 1:
                comp_hdr = _native.bgzf_compress(
                    np.frombuffer(header_bytes, dtype=np.uint8)
                )
                _write_all(fd, memoryview(comp_hdr))
                state["gz_bytes"] += len(comp_hdr)
            # multi-process: process 0 writes the header during the merge
        else:
            _pwrite_all(fd, header_bytes, 0)
        block_los = list(range(0, total_rows, vb))
        staged = reader.submit(stage_block, block_los[0]) if block_los else None
        for bi in range(len(block_los)):
            with timer.stage("stage_read"):
                lo, hi, n, packed, valid, host_pred, rows_blk, ls_blk, le_blk = staged.result()
            if bi + 1 < len(block_los):
                staged = reader.submit(stage_block, block_los[bi + 1])
            with timer.stage("h2d", nbytes=packed.nbytes):
                packed_d = jax.device_put(packed, shard_2d)
                valid_d = jax.device_put(valid, shard_1d)

            def _host_pred():
                if host_pred is not None:
                    return jax.device_put(host_pred, shard_1d)
                pred = np.zeros(vb, dtype=bool)
                pred[:n] = host_var_mask[lo:hi]
                return jax.device_put(pred, shard_1d)

            if cols is None:
                pred_d = _host_pred()
            else:
                pred_d = {}
                for name, (mat, lens) in cols.items():
                    m = np.zeros((vb, mat.shape[1]), dtype=mat.dtype)
                    m[:n] = mat[lo:hi]
                    ln = np.zeros(vb, dtype=np.int32)
                    ln[:n] = lens[lo:hi]
                    pred_d[name] = (
                        jax.device_put(m, shard_2d),
                        jax.device_put(ln, shard_1d),
                    )
            args = (packed_d, pred_d, valid_d)
            try:
                with timer.stage("device_step"):
                    out = step(*args)
            except DeviceFallback:
                # expression left the device subset mid-trace: fall back to
                # a host-computed mask for this and all later blocks. The
                # blocks keep their all-rows layout (universe stays None);
                # only the predicate moves to the host.
                cols = None
                host_var_mask, _ = compute_masks(
                    var_node, None, pvar, psam, header, records, "device"
                )
                step = build_mesh_pipeline_step(mesh, None, planes=True)
                args = (packed_d, _host_pred(), valid_d)
                with timer.stage("device_step"):
                    out = step(*args)
            text_words, mask, counts = out
            pending.append((bi, n, rows_blk, ls_blk, le_blk, text_words, mask, counts))
            if len(pending) >= 2:
                drain(pending.popleft())
        while pending:
            drain(pending.popleft())
        if gz:
            if nproc == 1:
                from pgen_tpu.pipeline.filter import BGZF_EOF

                _write_all(fd, memoryview(BGZF_EOF))
                state["gz_bytes"] += len(BGZF_EOF)
            else:
                state["gz_bytes"] = _merge_gz_parts(
                    out_file, header_bytes, nproc, pid
                )
        else:
            # every process computes the same final size; trims any stale
            # tail from a previous larger file at this path
            os.ftruncate(fd, state["byte_base"])
    finally:
        reader.shutdown(wait=False, cancel_futures=True)
        if fd >= 0:
            os.close(fd)

    if index and (nproc == 1 or pid == 0):
        from pgen_tpu.pipeline.filter import emit_tabix_index

        var_idx = (
            np.concatenate(kept_rows)
            if kept_rows
            else np.zeros(0, dtype=np.int64)
        )
        ls_all = (
            np.concatenate(kept_ls) if kept_ls else np.zeros(0, dtype=np.int64)
        )
        le_all = (
            np.concatenate(kept_le) if kept_le else np.zeros(0, dtype=np.int64)
        )
        psz = np.zeros(len(var_idx) + 1, dtype=np.int64)
        np.cumsum(le_all - ls_all + 3, out=psz[1:])
        with timer.stage("index"):
            emit_tabix_index(
                out_file,
                pvar,
                var_idx,
                psz,
                row_fixed,
                len(header_bytes),
                fmt=index_format,
            )
    if gz and nproc > 1:
        # everyone returns only once the merged file (and index) exists
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("pgen_tpu_mesh_gz_done")

    log.info("mesh filter: %s", timer.report())
    return FilterResult(
        out_path=out_file,
        num_variants_kept=state["rows"],
        num_samples_kept=n_kept,
        bytes_written=state["gz_bytes"] if gz else state["byte_base"],
        timer=timer,
    )


def _merge_gz_parts(out_file: str, header_bytes: bytes, nproc: int, pid: int) -> int:
    """Multi-process BGZF finish: barrier until every process's part files
    exist, then process 0 concatenates compressed header + parts in global
    (block, shard) order + EOF. BGZF members concatenate losslessly
    (SAM spec §4.1), exactly like parallel/shard.py _concat_gz_parts."""
    import glob

    from jax.experimental import multihost_utils

    from pgen_tpu.native import native
    from pgen_tpu.pipeline.filter import BGZF_EOF, _write_all

    multihost_utils.sync_global_devices("pgen_tpu_mesh_gz_parts")
    if pid != 0:
        return 0
    total = 0
    parts = sorted(glob.glob(f"{out_file}.mesh.b*.part"))
    fd = os.open(out_file, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        comp_hdr = native.bgzf_compress(np.frombuffer(header_bytes, dtype=np.uint8))
        _write_all(fd, memoryview(comp_hdr))
        total += len(comp_hdr)
        for part in parts:
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
    for part in parts:
        os.unlink(part)
    return total
