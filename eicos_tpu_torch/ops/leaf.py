"""The leaf of the dense LDL^T recursion: the port of
``eicos_tpu.ops.pallas_leaf_ds`` (``leaf_ldl_pallas_ds``, and
``_leaf_ds_batch`` under the lane vmap) in f64 (``csrc/leaf_ldl.cu``) and
of ``eicos_tpu.ops.pallas_leaf`` (``leaf_ldl_pallas``) in f32
(``csrc/leaf_ldl_f32.cu``).

``leaf_ldl`` factors a batch of 128x128 blocks, M = L diag(d) L^T,
unpivoted with |d| clamped at 1e-150 (f64) or 1e-20 (f32), and returns the
unit-lower inverse Linv = L^{-1} and d.  Only the lower triangle of M is
read.  For a CUDA tensor the wrapper launches the kernel of the tensor's
type and counts the launch in ``kernels.COUNTS`` (``leaf_ldl`` or
``leaf_ldl_f32``); for a CPU tensor it runs the plain version, the
reference's ``_unblocked_ldl`` + ``_unit_lower_inv`` (``ops/band_ldl.py``).

Of the reference's two f32 leaves the XLA one clamps its pivots at 1e-20
and the Pallas one does not; the port clamps in the kernel and in the
plain version.  Both f32 kernels and the plain version compute in f32
throughout; the kernel inverts L by substitution, the plain version and
the TPU kernel by Newton-Schulz doubling.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels
from .band_ldl import B, _unblocked_ldl, leaf_ldl_plain  # noqa: F401


def leaf_ldl(Ms: torch.Tensor, out: Optional[tuple] = None):
    """(L, 128, 128) f64 or f32 symmetric blocks -> (Linv (L, 128, 128),
    d (L, 128)) of the same type.  ``Ms`` may be a strided view (unit
    stride along its rows).  With ``out=(Linv, d)``, views of the same
    shapes, the result is written there (the dense recursion writes each
    leaf straight into its diagonal block of the factor) and ``out`` is
    returned."""
    if kernels.on_cpu(Ms):
        Linv, d = leaf_ldl_plain(Ms)
        if out is None:
            return Linv, d
        out[0].copy_(Linv)
        out[1].copy_(d)
        return out
    lanes = Ms.shape[0]
    dev = Ms.device
    if Ms.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"Ms: dtype {Ms.dtype}, expected float64 or "
                         f"float32")
    f32 = Ms.dtype == torch.float32
    name = "leaf_ldl_f32" if f32 else "leaf_ldl"
    kernels.check("Ms", Ms, (lanes, B, B), dev, contiguous=False,
                  unit_rows=True, dtype=Ms.dtype)
    if out is None:
        out = (torch.empty((lanes, B, B), dtype=Ms.dtype, device=dev),
               torch.empty((lanes, B), dtype=Ms.dtype, device=dev))
    Linv, d = out
    kernels.check("Linv", Linv, (lanes, B, B), dev, contiguous=False,
                  unit_rows=True, dtype=Ms.dtype)
    kernels.check("d", d, (lanes, B), dev, contiguous=False,
                  unit_rows=True, dtype=Ms.dtype)
    fn = (kernels.lib(name).eicos_leaf_ldl_f32 if f32
          else kernels.lib(name).eicos_leaf_ldl)
    with torch.cuda.device(dev):
        kernels.launch(fn, Ms.data_ptr(), Ms.stride(0), Ms.stride(1),
                       Linv.data_ptr(), Linv.stride(0), Linv.stride(1),
                       d.data_ptr(), d.stride(0), lanes, kernels.stream(Ms))
    kernels.COUNTS[name] += 1
    return out
