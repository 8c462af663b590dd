"""Device/host compute ops.

Lazy export surface (PEP 562): importing a sibling like
``pgen_tpu.ops.gt_stats`` must NOT drag in jax (~1 s) through this
package __init__ — the CLI's default native path runs whole filters
without touching jax. ``from pgen_tpu.ops import unpack_codes`` still
works; the kernel modules load on first attribute access.
"""

_LAZY = {
    "unpack_codes": "pgen_tpu.ops.unpack",
    "unpack_codes_reference": "pgen_tpu.ops.unpack",
    "pack_codes_device": "pgen_tpu.ops.pack",
    "genotype_text": "pgen_tpu.ops.gt_text",
    "genotype_text_from_codes": "pgen_tpu.ops.gt_text",
    "genotype_text_planes": "pgen_tpu.ops.gt_text",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'pgen_tpu.ops' has no attribute {name!r}")
