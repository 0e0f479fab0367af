"""Exact kernelization front-end: s,t-safe reductions, kernel assembly,
contraction-derived instances, weight-drift kernel patching, and
solution lifting.

The port's own copy of the JAX package's ``repro.presolve`` (numpy only):
the same rules, kernels, patches and lifts, with connected components
from scipy (``rules._connected_components``) labelled as the JAX package
labels them."""
from .rules import RULES, Reduction, reduce_instance
from .contract import (Kernel, DerivedInstance, WeightMap, kernelize,
                       patch_kernel, derive_instance, contraction_map,
                       MERGED_SOURCE, MERGED_SINK, ELIMINATED)
from .lift import lift_partition, lift_voltages, cut_certificate

__all__ = [
    "RULES", "Reduction", "reduce_instance",
    "Kernel", "DerivedInstance", "WeightMap", "kernelize", "patch_kernel",
    "derive_instance", "contraction_map",
    "MERGED_SOURCE", "MERGED_SINK", "ELIMINATED",
    "lift_partition", "lift_voltages", "cut_certificate",
]
