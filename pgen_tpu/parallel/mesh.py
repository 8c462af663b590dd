"""Device-mesh sharded filter step: the multi-GPU compute path.

The workload has one long axis — variants (SURVEY.md §5 "Long-context"):
the genotype matrix shards over it as P('v', None) on a 1-D
``jax.sharding.Mesh``; the sample axis stays whole per device. The mesh is
1-D because every GPU of a host reaches every other at the same rate over
NVLink. One jitted step runs, per shard:

    predicate mask (device, over sharded padded column tensors)
    -> stable compacting reorder (kept variants first, original order)
    -> 2-bit unpack -> GT text words
    -> all_gather of kept counts over 'v'  (the ordered-merge collective:
       every shard learns every shard's kept count, hence its own global
       output row offset — SURVEY.md §7 L4)

Outputs stay sharded; hosts write their shards at the derived offsets.
The only collective is a ndev-long i32 all-gather per step (the variant
text itself never crosses devices).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pgen_tpu.ops.gt_text import _text_word
from pgen_tpu.ops.unpack import _unpack_words

VARIANT_AXIS = "v"


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over the variant axis (all local devices by default)."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (VARIANT_AXIS,))


def _local_step(packed, mask):
    """Per-shard compute: compact kept rows, decode, format; count kept."""
    # stable partition: kept rows first, in original variant order
    order = jnp.argsort(jnp.logical_not(mask), stable=True)
    gathered = jnp.take(packed, order, axis=0)
    words = _unpack_words(gathered)  # (v_local, R) u32: 4 codes per word
    v, r = words.shape
    codes = jax.lax.bitcast_convert_type(words, jnp.uint8).reshape(v, 4 * r)
    text_words = _text_word(codes.astype(jnp.uint32))  # (v_local, 4R) u32
    count = jnp.sum(mask.astype(jnp.int32))
    return text_words, count


def build_sharded_filter_step(mesh: Mesh):
    """Jitted (packed, mask) -> (text_words, counts, offsets) over the mesh.

    packed: (V, R) u8 sharded P('v', None); mask: (V,) bool sharded P('v').
    Returns per-shard-compacted text words (V, 4R) u32 sharded P('v', None),
    kept counts (ndev,) and global row offsets (ndev,) — replicated.
    """

    def step(packed, mask):
        def inner(packed_l, mask_l):
            text_words, count = _local_step(packed_l, mask_l)
            counts = jax.lax.all_gather(count, VARIANT_AXIS)  # (ndev,)
            offsets = jnp.cumsum(counts) - counts
            return text_words, counts, offsets

        return jax.shard_map(
            inner,
            mesh=mesh,
            in_specs=(P(VARIANT_AXIS, None), P(VARIANT_AXIS)),
            out_specs=(P(VARIANT_AXIS, None), P(), P()),
            check_vma=False,
        )(packed, mask)

    in_shardings = (
        NamedSharding(mesh, P(VARIANT_AXIS, None)),
        NamedSharding(mesh, P(VARIANT_AXIS)),
    )
    return jax.jit(step, in_shardings=in_shardings)


def build_sharded_predicate_and_filter_step(mesh: Mesh, expr_ast, col_names):
    """Full step with the predicate fused in: column tensors -> text.

    col_names orders the (mat, lens) pairs passed positionally (pytrees of
    sharded arrays); the include-expression lowers to device ops inside the
    same jit (query/compile_device.py).
    """
    from pgen_tpu.query.compile_device import lower_device

    def step(packed, cols):
        def inner(packed_l, cols_l):
            mask_l = lower_device(expr_ast, cols_l) if expr_ast is not None else jnp.ones(
                packed_l.shape[0], dtype=bool
            )
            text_words, count = _local_step(packed_l, mask_l)
            counts = jax.lax.all_gather(count, VARIANT_AXIS)
            offsets = jnp.cumsum(counts) - counts
            return text_words, counts, offsets

        col_specs = {k: (P(VARIANT_AXIS, None), P(VARIANT_AXIS)) for k in cols}
        return jax.shard_map(
            inner,
            mesh=mesh,
            in_specs=(P(VARIANT_AXIS, None), col_specs),
            out_specs=(P(VARIANT_AXIS, None), P(), P()),
            check_vma=False,
        )(packed, cols)

    return jax.jit(step)


def _local_pipeline(packed_l, mask_l, sample_sel, compact: bool = True):
    """Shard-local compute shared by the end-to-end mesh steps.

    Compacts kept rows to the front (stable: original variant order),
    unpacks, optionally gathers the kept-sample columns, and formats GT
    text words. Returns (text_words, count). compact=False skips the
    argsort+gather when the caller guarantees the mask is already a
    prefix-run of ones (host pre-gathered the kept rows) — saves the
    2 B/record-byte gather pass.
    """
    if compact:
        order = jnp.argsort(jnp.logical_not(mask_l), stable=True)
        gathered = jnp.take(packed_l, order, axis=0)
    else:
        gathered = packed_l
    words = _unpack_words(gathered)  # (v_local, R) u32: 4 codes per word
    v, r = words.shape
    codes = jax.lax.bitcast_convert_type(words, jnp.uint8).reshape(v, 4 * r)
    if sample_sel is not None:
        codes = jnp.take(codes, sample_sel, axis=1)
    text_words = _text_word(codes.astype(jnp.uint32))
    count = jnp.sum(mask_l.astype(jnp.int32))
    return text_words, count


def _local_pipeline_planes(packed_l, mask_l, compact: bool = True):
    """Plane-form shard-local compute: keep-all-samples fast path.

    Instead of the interleaved text layout (byte j -> output u32 words
    4j..4j+3) the step emits FOUR dense planes — plane k holds the text
    word of sample 4j+k at word j, pure elementwise from the packed byte:

        code_k = (byte >> 2k) & 3;  t_k = text_word(code_k)

    (no unpack bitcast, no interleave anywhere on device); the host
    assembler interleaves plane words while copying rows (a sequential
    4-stream merge at DRAM speed). Returns ((t0, t1, t2, t3), count).
    """
    from pgen_tpu.ops.gt_text import planes_from_packed

    if compact:
        order = jnp.argsort(jnp.logical_not(mask_l), stable=True)
        gathered = jnp.take(packed_l, order, axis=0)
    else:
        gathered = packed_l
    planes = planes_from_packed(gathered)
    count = jnp.sum(mask_l.astype(jnp.int32))
    return planes, count


def build_mesh_pipeline_step(
    mesh: Mesh, expr_ast, precompacted: bool = False, planes: bool = False
):
    """The end-to-end per-block device step driven by the CLI filter path
    (pipeline/mesh_filter.py): what SURVEY.md §7 L4 calls the flagship
    multi-chip pipeline.

    Signature (all jit-placed by in_shardings):
      expr_ast given:  step(packed, cols, valid[, sample_sel])
      expr_ast None:   step(packed, mask, valid[, sample_sel])
    where packed is (V, R) u8 P('v', None); cols maps column name ->
    (padded u8 matrix P('v', None), lengths P('v')); valid is (V,) bool
    P('v') masking padding rows; sample_sel is a replicated i32 vector of
    kept sample indices (None/absent = all samples in record order).

    Returns (text_words P('v', None), mask replicated, counts replicated
    (ndev,)) — the all-gather ordered-merge collective: every shard
    learns every shard's kept count and hence its global output row
    offset (derived on host as cumsum(counts)).

    precompacted=True (host already gathered kept rows; mask is a prefix
    of ones per shard) skips the on-device argsort+gather.

    planes=True (keep-all-samples only: no sample_sel) emits the text as
    four dense (v, R) u32 planes instead of one interleaved (v, 4R)
    tensor — see _local_pipeline_planes for why this is ~10x faster to
    materialize; the first return value becomes the 4-tuple of planes.
    """
    from pgen_tpu.query.compile_device import lower_device

    def step(packed, pred_in, valid, *sel):
        sample_sel = sel[0] if sel else None

        def inner(packed_l, pred_l, valid_l, *sel_l):
            if expr_ast is not None:
                mask_l = lower_device(expr_ast, pred_l) & valid_l
            else:
                mask_l = pred_l & valid_l
            if planes:
                text_out, count = _local_pipeline_planes(
                    packed_l, mask_l, compact=not precompacted
                )
            else:
                text_out, count = _local_pipeline(
                    packed_l, mask_l, sel_l[0] if sel_l else None,
                    compact=not precompacted,
                )
            counts = jax.lax.all_gather(count, VARIANT_AXIS)
            # replicate the mask (vb bits): every HOST needs the
            # whole block's mask for its row-offset arithmetic — with
            # process-sharded devices a P('v') mask would have
            # non-addressable shards. (Row offsets are cumsum(counts) on
            # host; no device-side offsets output.)
            mask_g = jax.lax.all_gather(mask_l, VARIANT_AXIS, tiled=True)
            return text_out, mask_g, counts

        if expr_ast is not None:
            pred_spec = {k: (P(VARIANT_AXIS, None), P(VARIANT_AXIS)) for k in pred_in}
        else:
            pred_spec = P(VARIANT_AXIS)
        in_specs = [P(VARIANT_AXIS, None), pred_spec, P(VARIANT_AXIS)]
        if sample_sel is not None:
            in_specs.append(P())
        text_spec = (
            (P(VARIANT_AXIS, None),) * 4 if planes else P(VARIANT_AXIS, None)
        )
        return jax.shard_map(
            inner,
            mesh=mesh,
            in_specs=tuple(in_specs),
            out_specs=(text_spec, P(), P()),
            check_vma=False,
        )(packed, pred_in, valid, *sel)

    return jax.jit(step)


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Zero-pad along axis so the dim divides the mesh size."""
    n = arr.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths)
