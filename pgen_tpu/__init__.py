"""pgen_tpu — a JAX engine for querying and filtering PLINK2 PGEN filesets.

A from-scratch JAX/XLA re-design of the capabilities of the reference
pgen-rs tool (bcftools-for-.pgen): the bit-packed 2-bit genotype matrix is
decoded and formatted by vectorized kernels over device-resident tiles, and
metadata predicates compile to boolean masks + compacting gathers. The variant
dimension shards across a ``jax.sharding.Mesh``; per-shard outputs merge in
variant order.

Package map (reference parity is cited per-module against /root/reference):
  formats/   .pgen header/geometry, .pvar/.psam metadata, .pgen writer, describe
  query/     evalexpr-compatible expression engine: parser, row interp,
             vectorized compiler
  ops/       jax.numpy device ops: 2-bit unpack, pack, genotype->VCF-text
  pipeline/  filter (decode->mask->gather->format->write) and query paths
  parallel/  mesh construction, variant-dim sharding, ordered shard merge
  native/    C++ host runtime: metadata scan, VCF row assembly, file IO
  utils/     stderr logging, stage timers
"""

__version__ = "0.1.0"

from pgen_tpu.formats.header import PgenHeader, read_pgen_header
from pgen_tpu.formats.metadata import MetadataTable, read_metadata

__all__ = [
    "PgenHeader",
    "read_pgen_header",
    "MetadataTable",
    "read_metadata",
    "__version__",
]
