"""Hand-written CUDA kernels for the MTTKRP hot spots, with plain versions.

- fused_mttkrp: MTTKRP with the KRP tile formed in shared memory, never in HBM
- matrix_free:  streaming MTTKRP -- no matricization, no KRP at all
- multi_ttv:    the 2nd step of the 2-step MTTKRP (Alg. 4)
- krp_kernel:   the explicit KRP of two matrices (Alg. 1), ``krp_pair``
- gram_pinv:    the factor update's solve, ``pinv`` of the Hadamard of the
                Grams (replaces no TPU kernel; reached as the module
                ``gram_pinv``, from ``plan/sweep.py::_pinv``)

The first three have an unbatched and a batched form (a leading slab axis:
one slab per thread block along the grid's z axis).  ops.py holds the
wrappers (partial-KRP split, views, mode dispatch, the KRP fold and the
kernelized 2-step MTTKRP); ref.py the plain-torch oracles the tests compare
against.  The multi-TTV wrappers are reached as ``ops.multi_ttv`` /
``ops.multi_ttv_batched`` (a package-level ``multi_ttv`` would hide the
module of that name); the package exports the low-level entries
``multi_ttv_kernel`` / ``multi_ttv_batched_kernel``, as the reference does.  A CUDA tensor launches a kernel, a CPU tensor takes
its plain version.  Every kernel but ``gram_pinv`` (float32 and float64)
takes float32, bfloat16, float16 and float64 operands of one dtype (``_tiling.KERNEL_DTYPES``), read at their own
width; the MTTKRP and multi-TTV kernels sum in fp32 and return float32.
"""

from . import ops, ref
from .fused_mttkrp import (
    fused_mttkrp_bilinear,
    fused_mttkrp_bilinear_batched,
    fused_mttkrp_bilinear_batched_plain,
    fused_mttkrp_bilinear_plain,
)
from .krp_kernel import krp_pair, krp_pair_plain
from .matrix_free import (
    matrix_free_batched_kernel,
    matrix_free_batched_kernel_plain,
    matrix_free_kernel,
    matrix_free_kernel_plain,
    matrix_free_mttkrp,
    matrix_free_mttkrp_batched,
)
from .multi_ttv import multi_ttv_batched_kernel, multi_ttv_kernel

__all__ = [
    "ops",
    "ref",
    "fused_mttkrp_bilinear",
    "fused_mttkrp_bilinear_batched",
    "fused_mttkrp_bilinear_batched_plain",
    "fused_mttkrp_bilinear_plain",
    "krp_pair",
    "krp_pair_plain",
    "matrix_free_batched_kernel",
    "matrix_free_batched_kernel_plain",
    "matrix_free_kernel",
    "matrix_free_kernel_plain",
    "matrix_free_mttkrp",
    "matrix_free_mttkrp_batched",
    "multi_ttv_kernel",
    "multi_ttv_batched_kernel",
]
