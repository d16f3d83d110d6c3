"""simd_radix_sort_tpu_torch — the PyTorch/CUDA port of simd_radix_sort_tpu.

The same sort API as the JAX package (10 key dtypes, payload streams in
lock-step, ascending and descending, the packed row layout, the method
registry) on torch tensors.  The counting engine and the radix engine's
bit-partition mover run on hand-written CUDA kernels for Hopper (csrc/,
built at first use); each kernel has a plain PyTorch version that serves
CPU tensors.  Entry points run on the CUDA
device unless the caller passes device="cpu".

The package imports torch and NumPy only; it never imports jax or the JAX
package.
"""

from .config import SortConfig
from .methods import REGISTRY as SORT_METHODS
from .ops.sort import (
    argsort,
    pack_rows,
    sort,
    sort_batched,
    sort_multi,
    sort_packed,
    sort_with_payloads,
    unpack_rows,
)
from .utils import common, transforms
from .utils.transforms import from_sortable, sort_np, to_sortable

__all__ = [
    "SortConfig",
    "SORT_METHODS",
    "sort",
    "argsort",
    "sort_batched",
    "sort_multi",
    "sort_with_payloads",
    "sort_packed",
    "pack_rows",
    "unpack_rows",
    "to_sortable",
    "from_sortable",
    "sort_np",
    "common",
    "transforms",
]

__version__ = "0.1.0"
