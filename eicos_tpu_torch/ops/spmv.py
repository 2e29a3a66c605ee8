"""Static-pattern products ``x @ M`` of the residuals and the LP-row
elimination: the port of ``eicos_tpu.ops.spmv`` (``csc_table``,
``SparseOperand``).

On MPC and LP families G and A hold a handful of nonzeros a column, so a
product with the dense equilibrated matrix reads mostly zeros.  With the
pattern static (``structure.MatvecPattern``), ``x @ M`` sums, for each
output column j, the W coefficient-weighted elements of x that the
column's nonzeros select.  ``csc_table`` builds the padded per-column
table, or refuses an operand whose widest column has more than
``WIDTH_MAX`` nonzeros (``kkt.make_sliced`` then takes the dense product).
``SparsePattern`` holds a table's index tensors on one device, built once
per structure; a solve's ``SparseOperand`` only gathers the coefficients
from the equilibrated matrix.

For a CUDA tensor ``SparseOperand.rmatmul`` launches ``csrc/spmv.cu`` (one
launch a product, counted in ``kernels.COUNTS["spmv"]``) on a CSC form of
the same table; for a CPU tensor it runs ``rmatmul_plain``, the JAX
package's gather with its width groups, so the two can be held against
each other on one table.  The JAX package computes this product as an XLA
gather, not a Pallas kernel: the kernel has no TPU counterpart.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import kernels

WIDTH_MAX = 16


def csc_table(src, out, km: int, nm: int):
    """Padded per-output-column table for an ``x @ M`` product
    (``eicos_tpu.ops.spmv.csc_table``).

    ``src``/``out``: arrays over M's nonzeros, the position along the
    contraction axis (row of M, in [0, km)) and the output column (column
    of M, in [0, nm)).  Returns (idx (nm, W) int32 padded with km, W), or
    None when W > WIDTH_MAX.  Each column lists its nonzeros in the order
    they come in ``src``/``out``."""
    src = np.asarray(src, np.int64)
    out = np.asarray(out, np.int64)
    counts = np.bincount(out, minlength=nm) if out.size else np.zeros(
        nm, np.int64)
    W = int(counts.max()) if nm else 0
    if W > WIDTH_MAX:
        return None
    W = max(W, 1)
    idx = np.full((nm, W), km, np.int32)
    order = np.argsort(out, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    cols = out[order]
    idx[cols, np.arange(order.size) - starts[cols]] = src[order]
    return idx, W


class SparsePattern:
    """The static part of a ``SparseOperand`` on one device: a table of
    ``csc_table`` (``idx`` (nm, W), padded with ``km``) and the index
    tensors built from it.  ``kkt._sliced_patterns`` makes one per
    structure and device, which every solve's operands share."""

    def __init__(self, idx: np.ndarray, W: int, km: int, device):
        idx = np.asarray(idx)
        nm = idx.shape[0]
        assert idx.shape == (nm, W), (idx.shape, nm, W)
        self.idx, self.W, self.km, self.nm = idx, W, km, nm
        self.device = torch.device(device)
        self.valid = idx < km
        self.counts = self.valid.sum(axis=1)
        # the kernel's CSC form: the table's slots without its pads
        self.colptr = torch.as_tensor(
            np.concatenate([[0], np.cumsum(self.counts)]),
            dtype=torch.int32, device=self.device)
        self.rows = torch.as_tensor(idx[self.valid], dtype=torch.int32,
                                    device=self.device)
        # each slot's (row, column) in the operand, for its coefficient
        self.src = self.rows.long()
        self.cols = torch.as_tensor(np.nonzero(self.valid)[0],
                                    device=self.device)

    @functools.cached_property
    def plain_groups(self):
        """The plain version's width groups (``eicos_tpu.ops.spmv``):
        output columns split into power-of-two classes of nonzero count,
        where that removes at least a quarter of the slots of 256 columns
        or more.  (inverse permutation, [(w, flat table, columns)]), or
        None."""
        nm, W, dev = self.nm, self.W, self.device
        cls_w = np.minimum(W, np.maximum(1, 1 << np.ceil(
            np.log2(np.maximum(self.counts, 1))).astype(np.int64)))
        if not (nm >= 256 and int(cls_w.sum()) * 4 <= nm * W * 3):
            return None
        order = np.argsort(cls_w, kind="stable")
        inv = np.empty(nm, np.int64)
        inv[order] = np.arange(nm)
        groups = []
        for w in sorted(set(int(v) for v in cls_w)):
            cols = order[cls_w[order] == w]
            groups.append((w, torch.as_tensor(
                self.idx[cols, :w].ravel().astype(np.int64), device=dev),
                torch.as_tensor(cols, device=dev)))
        return torch.as_tensor(inv, device=dev), groups

    @functools.cached_property
    def idxf(self) -> torch.Tensor:
        """The whole padded table, flat: the ungrouped plain gather."""
        return torch.as_tensor(self.idx.ravel().astype(np.int64),
                               device=self.device)


class SparseOperand:
    """``x @ M`` with a static padded-CSC pattern, a drop-in for the wide
    operand's ``rmatmul``.  ``bmat`` is the (km, nm) operand in the product
    orientation, shared, or (L, km, nm) per lane; ``idx`` (nm, W) its table
    from ``csc_table``, or ``pattern`` its ``SparsePattern`` on bmat's
    device.  Building one gathers the coefficients, nothing else.

    The plain form keeps the JAX package's width groups, built at its
    first call; the kernel form is the pattern's CSC array."""

    def __init__(self, bmat: torch.Tensor, idx=None, W=None,
                 pattern: SparsePattern = None):
        km, nm = bmat.shape[-2:]
        if pattern is None:
            pattern = SparsePattern(idx, W, km, bmat.device)
        assert (pattern.km, pattern.nm) == (km, nm), (
            (pattern.km, pattern.nm), (km, nm))
        self.pattern = pattern
        self.km, self.nm, self.W = km, nm, pattern.W
        self.colptr, self.rows = pattern.colptr, pattern.rows
        self.vals = bmat[..., pattern.src, pattern.cols]   # ([L,] nnz)

    @functools.cached_property
    def coef(self) -> torch.Tensor:
        """The padded table's coefficients ([L,] nm, W), 0 at the pads
        (the JAX package gathers them from an appended zero row)."""
        lead = self.vals.shape[:-1]
        coef = self.vals.new_zeros(*lead, self.nm * self.W)
        coef[..., torch.as_tensor(np.flatnonzero(self.pattern.valid),
                                  device=self.vals.device)] = self.vals
        return coef.reshape(*lead, self.nm, self.W)

    @functools.cached_property
    def groups(self):
        """[(w, flat table, coefficients)] a width group, or None."""
        plain = self.pattern.plain_groups
        if plain is None:
            return None
        return [(w, idxf, self.coef[..., cols, :w])
                for w, idxf, cols in plain[1]]

    def _lanes(self, a):
        """a (L, k, km) or (L, km) -> (L, k, km), and whether it was 2-d."""
        assert a.shape[-1] == self.km, (tuple(a.shape), self.km)
        return (a[:, None], True) if a.dim() == 2 else (a, False)

    def rmatmul_plain(self, a: torch.Tensor) -> torch.Tensor:
        """Plain version of ``rmatmul`` (``eicos_tpu.ops.spmv``'s gather):
        x @ M for a (L, k, km) or (L, km)."""
        a3, flat = self._lanes(a)
        ap = torch.cat([a3, a3.new_zeros(*a3.shape[:-1], 1)], -1)
        lead = ap.shape[:-1]
        # a per-lane table broadcasts over the k rows
        per_lane = (lambda c: c[:, None]) if self.vals.dim() == 2 else (
            lambda c: c)
        if self.groups is None:
            t = ap[..., self.pattern.idxf].reshape(*lead, self.nm, self.W)
            res = (t * per_lane(self.coef)).sum(-1)
        else:
            parts = []
            for w, idxf, coef in self.groups:
                t = ap[..., idxf].reshape(*lead, coef.shape[-2], w)
                parts.append((t * per_lane(coef)).sum(-1))
            res = torch.cat(parts, -1)[..., self.pattern.plain_groups[0]]
        return res[:, 0] if flat else res

    def rmatmul(self, a: torch.Tensor) -> torch.Tensor:
        """x @ M for a (L, k, km) or (L, km) f64: the kernel on a CUDA
        tensor, the plain version on a CPU one."""
        if kernels.on_cpu(a):
            return self.rmatmul_plain(a)
        a3, flat = self._lanes(a)
        res = spmv(a3.contiguous(), self.colptr, self.rows, self.vals,
                   self.nm)
        return res[:, 0] if flat else res


def spmv(a: torch.Tensor, colptr: torch.Tensor, rows: torch.Tensor,
         vals: torch.Tensor, nm: int) -> torch.Tensor:
    """out[l, r, j] = sum_t vals[l, t] a[l, r, rows[t]] over t in
    colptr[j]..colptr[j+1], in that order, on the card.  ``a`` (L, k, km)
    f64 contiguous, ``colptr`` (nm + 1,) and ``rows`` (nnz,) int32,
    ``vals`` (nnz,) shared or (L, nnz) per lane."""
    if a.dim() != 3:
        raise ValueError(f"spmv: a must be (L, k, km), got {tuple(a.shape)}")
    lanes, k, km = a.shape
    dev = a.device
    nnz = rows.shape[0]
    kernels.check("a", a, (lanes, k, km), dev)
    kernels.check("colptr", colptr, (nm + 1,), dev, dtype=torch.int32)
    kernels.check("rows", rows, (nnz,), dev, contiguous=nnz > 0,
                  dtype=torch.int32)
    kernels.check("vals", vals, (lanes, nnz)[2 - vals.dim():], dev,
                  contiguous=nnz > 0)
    out = torch.empty((lanes, k, nm), dtype=a.dtype, device=dev)
    if lanes * k and nm:
        with torch.cuda.device(dev):
            kernels.launch(kernels.lib("spmv").eicos_spmv,
                           a.data_ptr(), colptr.data_ptr(), rows.data_ptr(),
                           vals.data_ptr(), nnz if vals.dim() == 2 else 0,
                           out.data_ptr(), lanes, k, km, nm,
                           kernels.stream(a))
        kernels.count("spmv")
    return out
