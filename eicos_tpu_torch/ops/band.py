"""Wrappers of the band LDL^T kernels: the port of
``eicos_tpu.ops.pallas_band_ds`` at block bandwidths 1..6
(``csrc/band_factor_bw.cu``, ``csrc/band_solve_bw.cu``), and the dispatch
between them and the scan of ``ops/band_ldl.py``.

Every band has one layout: diagonal blocks ``Kd`` (lanes, nb, 128, 128)
and sub-diagonal blocks ``Ks`` (lanes, nb, bw, 128, 128) with
``Ks[:, k, j-1] = K[k, k-j]``; a factor's ``L`` has the layout of ``Ks``.
``band_factor``, ``band_fwd``, ``band_bwd`` and ``band_solve`` dispatch on
the bandwidth and the type.  Where the reference's band kernels do not
run, a band wider than 6 or an f32 factor, these four run the scan
(``band_ldl_factor`` / ``band_ldl_solve``: batched ``torch.matmul``
products, in ``gemm_dtype`` when it is given, and the leaf kernel
``ops/leaf.leaf_ldl`` on a CUDA tensor), as the reference runs its XLA
scan there.  Otherwise they call the kernel wrappers, and ``gemm_dtype``
is not read (the kernels compute in f64, as the reference's do).

The kernel wrappers ``band_factor_bw``, ``band_fwd_bw`` and ``band_bwd_bw``
take block bandwidths 1..6 (the reference's own bound) and raise outside.
At bw 1, where the lanes leave SMs idle, ``band_factor_bw`` launches the
same factor on a cluster of CTAs a lane (``csrc/band_factor_cluster.cu``,
counted as ``band_factor_cluster``; the same bits): ``cluster_size`` is the
rule, fed by the lane count, the bandwidth and what the card reports.
The sweeps stream the factor through a ring of panels in shared memory
(``csrc/band_solve_bw.cu``): ``sweep_stages`` is its depth, fed by the
bandwidth, the right-hand sides' width, the card's shared memory a block
and the clusters of the sweep that the card holds at once; the depth does
not change the bits.
For a CUDA tensor each checks its inputs, allocates its outputs with
``torch.empty``, launches its kernel on the current stream and counts the
launch in ``kernels.COUNTS``; a launch error raises.  For a CPU tensor it
runs the plain twin of ``ops/band_ldl.py``.  Nothing falls back from a
kernel to a twin or to the scan.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import kernels
from .band_ldl import (B, KP, BandFactors, band_bwd_bw_plain,
                       band_factor_bw_plain, band_fwd_bw_plain, band_ldl_bwd,
                       band_ldl_factor, band_ldl_fwd)

BW_MAX = 6    # widest block band of the wide kernels
CLUSTERS = (8, 4, 2)    # CTAs a lane of the cluster factor, widest first
# the sweeps' CTA (``csrc/band_solve_bw.cu``): rows it owns, threads a row,
# a ring slot (a panel of 2048 doubles, rows padded by 2), its widths
SWEEP_R, SWEEP_NG, SWEEP_SLOT = 64, 4, 64 * 34
SWEEP_KT = (2, 8, 16)
PANEL_BYTES = 2048 * 8     # of the factor, a panel
SWEEP_STAGES_MIN = 4       # the ring whose residency `sweep_stages` keeps


def scan(Ks: torch.Tensor, dtype: torch.dtype) -> bool:
    """True where the scan runs instead of the kernels: sub-diagonal
    blocks (or a factor's ``L``) ``Ks`` wider than ``BW_MAX``, in another
    type than f64, or of another block size than 128 (the JAX package's
    band kernels take 128-blocks only)."""
    return (dtype != torch.float64 or Ks.shape[2] > BW_MAX
            or Ks.shape[-1] != B)


def band_factor(Kd: torch.Tensor, Ks: torch.Tensor,
                gemm_dtype=None) -> BandFactors:
    """Block-banded LDL^T of (lanes, nb, 128, 128) diagonal blocks and the
    (lanes, nb, bw, 128, 128) sub-diagonal blocks ``Ks`` -> L (as ``Ks``),
    Dinv (lanes, nb, 128, 128) and d (lanes, nb, 128), in the type of
    ``Kd``.  ``Ks[:, k, j-1]`` for k < j is ignored.  A 4-d ``Ks``
    (lanes, nb, 128, 128) is read as bandwidth 1, as ``benchmark/`` times
    it.  ``gemm_dtype`` is the scan's product type (module doc)."""
    if Ks.dim() == 4:
        Ks = Ks[:, :, None]
    if scan(Ks, Kd.dtype):
        return band_ldl_factor(Kd, Ks, gemm_dtype)
    return band_factor_bw(Kd, Ks)


def _check_bw(bw: int) -> None:
    if not 1 <= bw <= BW_MAX:
        raise ValueError(f"block bandwidth {bw}: the wide band kernels take "
                         f"1..{BW_MAX}")


def cluster_size(lanes: int, bw: int, sms: int, active) -> int:
    """CTAs a lane for the band factor: the widest c of ``CLUSTERS`` such
    that bw is 1, ``lanes * c`` CTAs fit on the ``sms`` SMs (so each takes
    an SM that one CTA a lane leaves idle) and the card holds ``active[c]``
    >= ``lanes`` clusters of c at once (every lane in one wave); else 1,
    one CTA a lane (``band_factor_bw.cu``)."""
    if bw != 1:
        return 1
    for c in CLUSTERS:
        if lanes * c <= sms and active[c] >= lanes:
            return c
    return 1


def clusters(lanes: int, bw: int, device) -> int:
    """``cluster_size`` on CUDA ``device``: the CTAs a lane that
    ``band_factor_bw`` launches there for ``lanes`` lanes at bandwidth
    ``bw``."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return cluster_size(lanes, bw, *_card(index))


@functools.lru_cache(maxsize=None)
def _card(index: int) -> tuple:
    """(SMs, {c: clusters of c the card holds at once}) of CUDA device
    ``index``, asked once."""
    fn = kernels.lib("band_factor_cluster").eicos_band_factor_clusters
    active = {}
    with torch.cuda.device(index):
        for c in CLUSTERS:
            n = ctypes.c_int(0)
            kernels.launch(fn, c, ctypes.byref(n))
            active[c] = n.value
        sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms, active


def sweep_kt(k: int) -> int:
    """The width a sweep carries ``k`` right-hand sides at: 2, 8 or 16."""
    return next(kt for kt in SWEEP_KT if k <= kt)


def sweep_smem(stages: int, bw: int, kt: int) -> int:
    """Shared memory bytes of a sweep CTA with a ring of ``stages`` slots
    at bandwidth ``bw`` and width ``kt``: the ring, bw y blocks, the
    residual, the join's partial sums, then an mbarrier a slot twice and
    two exchange barriers (``smem_bytes`` of ``band_solve_bw.cu``)."""
    doubles = (stages * SWEEP_SLOT + (bw + 1) * B * kt
               + SWEEP_NG * SWEEP_R * kt)
    return 8 * doubles + 8 * (2 * stages + 2)


def sweep_stages(bw: int, kt: int, per_block: int, resident) -> int:
    """Slots of the sweeps' panel ring: the deepest ring that fits
    ``per_block`` bytes of shared memory beside the rest of a CTA's
    (``sweep_smem``) and keeps as many clusters resident as a ring of
    ``SWEEP_STAGES_MIN`` does, where ``resident(stages)`` is the clusters
    of the sweep the card holds at once: more lanes at once beat a deeper
    ring."""
    base = sweep_smem(0, bw, kt)
    stages = (per_block - base) // (sweep_smem(1, bw, kt) - base)
    floor = resident(SWEEP_STAGES_MIN)
    while stages > SWEEP_STAGES_MIN and resident(stages) < floor:
        stages -= 1
    return stages


def sweep_ring(bw: int, k: int, device) -> tuple:
    """(slots, bytes of the factor they hold) of the ring that the sweeps
    take on CUDA ``device`` at bandwidth ``bw`` for ``k`` right-hand
    sides."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    stages = _sweep_stages(index, bw, sweep_kt(k))
    return stages, stages * PANEL_BYTES


@functools.lru_cache(maxsize=None)
def _sweep_stages(index: int, bw: int, kt: int) -> int:
    """``sweep_stages`` on CUDA device ``index``, asked once: its shared
    memory a block, and the clusters of the forward and the backward sweep
    it holds at once (the fewer)."""
    lib = kernels.lib("band_solve_bw")
    n = ctypes.c_int(0)

    def resident(stages):
        held = []
        for fwd in (1, 0):
            kernels.launch(lib.eicos_band_sweep_clusters, fwd, kt, bw, stages,
                           ctypes.byref(n))
            held.append(n.value)
        return min(held)

    with torch.cuda.device(index):
        kernels.launch(lib.eicos_band_sweep_smem, ctypes.byref(n))
        return sweep_stages(bw, kt, n.value, resident)


def band_factor_bw(Kd: torch.Tensor, Ksubs: torch.Tensor) -> BandFactors:
    """The wide band factor: ``Kd`` (lanes, nb, 128, 128), ``Ksubs``
    (lanes, nb, bw, 128, 128) f64 with ``Ksubs[:, k, j-1] = K[k, k-j]``,
    1 <= bw <= 6 -> L (layout of ``Ksubs``), Dinv, d.  ``Ksubs[:, k, j-1]``
    for k < j (a block left of block column 0) is ignored whatever it
    holds, and ``L[:, k, j-1]`` is written as zeros there, so the sweeps
    need no test."""
    bw = Ksubs.shape[2]
    _check_bw(bw)
    if kernels.on_cpu(Kd):
        return band_factor_bw_plain(Kd, Ksubs)
    lanes, nb = Kd.shape[0], Kd.shape[1]
    kernels.check("Kd", Kd, (lanes, nb, B, B), Kd.device)
    kernels.check("Ksubs", Ksubs, (lanes, nb, bw, B, B), Kd.device)
    L = torch.empty_like(Ksubs)
    Dinv = torch.empty_like(Kd)
    d = torch.empty((lanes, nb, B), dtype=Kd.dtype, device=Kd.device)
    # the cluster kernel's last argument is its CTAs a lane, the one-CTA
    # kernel's the bandwidth
    c = clusters(lanes, bw, Kd.device)
    name = "band_factor_cluster" if c > 1 else "band_factor_bw"
    with torch.cuda.device(Kd.device):
        kernels.launch(getattr(kernels.lib(name), "eicos_" + name),
                       Kd.data_ptr(), Ksubs.data_ptr(), L.data_ptr(),
                       Dinv.data_ptr(), d.data_ptr(), lanes, nb,
                       c if c > 1 else bw, kernels.stream(Kd))
    kernels.count(name)
    return BandFactors(L=L, Dinv=Dinv, d=d)


def _check_fac(fac: BandFactors, rhs: torch.Tensor):
    lanes, nb = fac.L.shape[0], fac.L.shape[1]
    k = rhs.shape[1]
    if not 1 <= k <= KP:
        raise ValueError(f"band solve takes 1..{KP} right-hand sides, got {k}")
    kernels.check("L", fac.L, (lanes, nb, fac.L.shape[2], B, B),
                  rhs.device)
    kernels.check("Dinv", fac.Dinv, (lanes, nb, B, B), rhs.device)
    kernels.check("d", fac.d, (lanes, nb, B), rhs.device)
    kernels.check("rhs", rhs, (lanes, k, nb * B), rhs.device)
    return lanes, nb, k


def band_fwd(fac: BandFactors, rhs: torch.Tensor,
             gemm_dtype=None) -> torch.Tensor:
    """Forward sweep and pivot scaling: rhs (lanes, k, Dp) -> w with
    y_k = Dinv_k (x_k - sum_j L[k,k-j] y_{k-j}), w = y / d."""
    if scan(fac.L, fac.d.dtype):
        return band_ldl_fwd(fac, rhs, gemm_dtype)
    return band_fwd_bw(fac, rhs)


def band_bwd(fac: BandFactors, w: torch.Tensor,
             gemm_dtype=None) -> torch.Tensor:
    """Backward sweep: w (lanes, k, Dp) -> z with
    z_k = Dinv_k^T (w_k - sum_j L[k+j,k]^T z_{k+j})."""
    if scan(fac.L, fac.d.dtype):
        return band_ldl_bwd(fac, w, gemm_dtype)
    return band_bwd_bw(fac, w)


def band_fwd_bw(fac: BandFactors, rhs: torch.Tensor) -> torch.Tensor:
    """The wide forward sweep: ``fac.L`` (lanes, nb, bw, 128, 128), rhs
    (lanes, k, Dp), k <= 16 -> w."""
    bw = fac.L.shape[2]
    _check_bw(bw)
    if kernels.on_cpu(rhs):
        return band_fwd_bw_plain(fac, rhs)
    lanes, nb, k = _check_fac(fac, rhs)
    out = torch.empty_like(rhs)
    stages, _ = sweep_ring(bw, k, rhs.device)
    with torch.cuda.device(rhs.device):
        kernels.launch(kernels.lib("band_solve_bw").eicos_band_fwd_bw,
                       fac.L.data_ptr(), fac.Dinv.data_ptr(), fac.d.data_ptr(),
                       rhs.data_ptr(), out.data_ptr(), lanes, nb, bw, k,
                       stages, kernels.stream(rhs))
    kernels.count("band_fwd_bw")
    return out


def band_bwd_bw(fac: BandFactors, w: torch.Tensor) -> torch.Tensor:
    """The wide backward sweep: w (lanes, k, Dp) -> z."""
    bw = fac.L.shape[2]
    _check_bw(bw)
    if kernels.on_cpu(w):
        return band_bwd_bw_plain(fac, w)
    lanes, nb, k = _check_fac(fac, w)
    out = torch.empty_like(w)
    stages, _ = sweep_ring(bw, k, w.device)
    with torch.cuda.device(w.device):
        kernels.launch(kernels.lib("band_solve_bw").eicos_band_bwd_bw,
                       fac.L.data_ptr(), fac.Dinv.data_ptr(), w.data_ptr(),
                       out.data_ptr(), lanes, nb, bw, k, stages,
                       kernels.stream(w))
    kernels.count("band_bwd_bw")
    return out


def band_solve(fac: BandFactors, rhs: torch.Tensor,
               gemm_dtype=None) -> torch.Tensor:
    """K x = rhs for rhs (lanes, k, Dp), k <= 16: the (KP, D) per-lane
    layout of ``eicos_tpu``'s ``band_solve_ds``."""
    return band_bwd(fac, band_fwd(fac, rhs, gemm_dtype), gemm_dtype)
