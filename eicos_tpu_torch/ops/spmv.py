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

For a CUDA tensor ``SparseOperand.rmatmul_fused`` launches ``csrc/spmv.cu``
(one launch a product, counted in ``kernels.COUNTS["spmv"]``) on a CSC
form of the same table, with the product site's work around it in the
same pass: a contraction input in two segments ``[a | a2]`` in place of a
``torch.cat``, and the affine tail ``((base op acc) + w) + gamma x`` of
``fused_tail``, optionally in two column segments.  For a CPU tensor it
runs ``rmatmul_plain``, the JAX package's gather with its width groups,
then ``fused_tail``'s torch ops, so the two can be held against each
other on one table.  The JAX package computes this product as an XLA
gather, not a Pallas kernel, inside a jitted step where XLA fuses the
tail: the kernel has no TPU counterpart.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np
import torch

from . import kernels

WIDTH_MAX = 16
OPS = {"add": 0, "sub": 1, "rsub": 2}     # base + acc, base - acc, acc - base


def _tail(y, base, op, w, gamma, x):
    if base is not None:
        y = (base + y if op == "add" else base - y if op == "sub"
             else y - base)
    elif op == "sub":
        y = -y
    if w is not None:
        y = y + w
    if x is not None:
        y = y + gamma * x
    return y


def _pair(v):
    return (None, None) if v is None else tuple(v)


def fused_tail(acc, base=None, op="add", w=None, gamma=0.0, x=None,
               split=None):
    """The fused call's epilogue as torch ops: ``((base op acc) + w) +
    gamma * x``, each term optional, op "add" (base + acc), "sub" (base -
    acc; no base: -acc) or "rsub" (acc - base), rounded op by op in this
    order, as the kernel rounds them.  With ``split`` the columns below it
    take the first of each pair ``base``, ``w``, ``x`` and the others the
    second (either may be None).  ``y + gamma * x`` with gamma = -d gives
    the bits of ``y - d * x``: IEEE defines a - b as a + (-b)."""
    if op not in OPS:
        raise ValueError(f"op must be one of {sorted(OPS)}, got {op!r}")
    if split is None:
        return _tail(acc, base, op, w, gamma, x)
    (b0, b1), (w0, w1), (x0, x1) = _pair(base), _pair(w), _pair(x)
    return torch.cat([_tail(acc[..., :split], b0, op, w0, gamma, x0),
                      _tail(acc[..., split:], b1, op, w1, gamma, x1)], -1)


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
    device.  Building one gathers the coefficients, nothing else (on a
    CPU tensor also the plain form's table of them).

    The plain form keeps the JAX package's width groups; the kernel form
    is the pattern's CSC array."""

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
        self._table = None      # the kernel's table arguments, checked once
        if kernels.on_cpu(bmat):
            # the plain form's coefficients are made with the values, so a
            # replayed solve prologue (``graphs``) makes both anew; the
            # kernel reads ``vals`` itself, in place
            _ = self.coef, self.groups

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
        return self.rmatmul_fused(a)

    def rmatmul_fused(self, a: torch.Tensor, a2: torch.Tensor = None,
                      base=None, op: str = "add", w=None, gamma: float = 0.0,
                      x=None, split: int = None) -> torch.Tensor:
        """``fused_tail(([a | a2]) @ M, base, op, w, gamma, x, split)``:
        one kernel launch on a CUDA tensor; on a CPU one ``rmatmul_plain``
        of the concatenation, then ``fused_tail``'s torch ops.  ``a`` (L,
        k, km0) or (L, km0), ``a2`` the remaining km - km0 columns of the
        contraction input (or None); ``base``, ``w``, ``x`` (pairs with
        ``split``) strided views of the output's shape (L, k, nm) or (L,
        nm) with unit column stride."""
        if kernels.on_cpu(a):
            ab = a if a2 is None else torch.cat([a, a2], -1)
            return fused_tail(self.rmatmul_plain(ab), base, op, w, gamma, x,
                              split)
        if self._table is None:
            self._table = _table(self.colptr, self.rows, self.vals, self.nm,
                                 a.device)
        if a.dim() == 3:
            return _launch(a, a2, self._table, self.nm, base, op, w, gamma,
                           x, split)
        if split is None:
            base, w, x = _lift(base), _lift(w), _lift(x)
        else:
            base, w, x = _lift_pair(base), _lift_pair(w), _lift_pair(x)
        return _launch(a[:, None], _lift(a2), self._table, self.nm, base, op,
                       w, gamma, x, split)[:, 0]


def _lift(t):
    return None if t is None else t[:, None]


def _lift_pair(v):
    return (None, None) if v is None else (_lift(v[0]), _lift(v[1]))


class _Strided(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("ls", ctypes.c_longlong),
                ("rs", ctypes.c_longlong)]


class _SpmvArgs(ctypes.Structure):
    """``EicosSpmvArgs`` of ``csrc/spmv.cu``, field for field: its layout
    (``_PACK`` packs a call's arguments in it as a flat array)."""
    _fields_ = [("a0", _Strided), ("a1", _Strided),
                ("km0", ctypes.c_longlong), ("colptr", ctypes.c_void_p),
                ("rows", ctypes.c_void_p), ("vals", ctypes.c_void_p),
                ("vstride", ctypes.c_longlong), ("out", ctypes.c_void_p),
                ("lanes", ctypes.c_longlong), ("k", ctypes.c_longlong),
                ("km", ctypes.c_longlong), ("nm", ctypes.c_longlong),
                ("op", ctypes.c_longlong), ("gamma", ctypes.c_double),
                ("split", ctypes.c_longlong), ("base", _Strided * 2),
                ("w", _Strided * 2), ("x", _Strided * 2)]


# every field eight bytes: pointers and integers as int64, gamma a double
_PACK = struct.Struct("<" + "".join(
    "d" if name == "gamma" else "q" * (ctypes.sizeof(ft) // 8)
    for name, ft in _SpmvArgs._fields_))
_NONE = (0, 0, 0)
F64 = torch.float64


def _view(name, t, shape, dev):
    """(pointer, lane stride, row stride) of a float64 view of ``shape``
    (L, k, cols) on ``dev`` with unit column stride; (0, 0, 0) for None."""
    if t is None:
        return _NONE
    if t.dtype is not F64 or t.shape != shape or t.device != dev:
        raise ValueError(f"spmv: {name} must be a float64 {shape} view on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    ls, rs, cs = t.stride()
    if cs != 1 and shape[2] > 1:
        raise ValueError(f"spmv: {name} must have unit column stride, got "
                         f"strides {t.stride()}")
    return t.data_ptr(), ls, rs


def _table(colptr, rows, vals, nm, dev):
    """The CSC table's part of the arguments, checked: (colptr, rows,
    vals pointers, the values' lane stride, their lanes or None)."""
    nnz = rows.shape[0]
    kernels.check("colptr", colptr, (nm + 1,), dev, dtype=torch.int32)
    kernels.check("rows", rows, (nnz,), dev, contiguous=nnz > 0,
                  dtype=torch.int32)
    if vals.dim() not in (1, 2):
        raise ValueError(f"spmv: vals must be (nnz,) or (L, nnz), got "
                         f"{tuple(vals.shape)}")
    kernels.check("vals", vals, vals.shape[:-1] + (nnz,), dev,
                  contiguous=nnz > 0)
    per_lane = vals.dim() == 2
    return (colptr.data_ptr(), rows.data_ptr(), vals.data_ptr(),
            nnz if per_lane else 0, vals.shape[0] if per_lane else None)


def _launch(a, a2, table, nm, base, op, w, gamma, x, split):
    """One launch of the kernel (see ``spmv``) on a checked table."""
    if op not in OPS:
        raise ValueError(f"spmv: op must be one of {sorted(OPS)}, got {op!r}")
    if a.dim() != 3:
        raise ValueError(f"spmv: a must be (L, k, km), got {tuple(a.shape)}")
    lanes, k, km0 = a.shape
    dev = a.device
    if table[4] is not None and table[4] != lanes:
        raise ValueError(f"spmv: {table[4]} lanes of values, {lanes} of a")
    km = km0 if a2 is None else km0 + a2.shape[-1]
    if split is None:
        shape = (lanes, k, nm)
        b0 = _view("base", base, shape, dev)
        w0 = _view("w", w, shape, dev)
        x0 = _view("x", x, shape, dev)
        b1 = w1 = x1 = _NONE
        split = nm
    else:
        if not 0 <= split <= nm:
            raise ValueError(f"spmv: split {split} outside [0, {nm}]")
        (p0, p1), (v0, v1), (y0, y1) = _pair(base), _pair(w), _pair(x)
        s0, s1 = (lanes, k, split), (lanes, k, nm - split)
        b0, b1 = _view("base[0]", p0, s0, dev), _view("base[1]", p1, s1, dev)
        w0, w1 = _view("w[0]", v0, s0, dev), _view("w[1]", v1, s1, dev)
        x0, x1 = _view("x[0]", y0, s0, dev), _view("x[1]", y1, s1, dev)
    out = torch.empty((lanes, k, nm), dtype=F64, device=dev)
    args = _PACK.pack(
        *_view("a", a, (lanes, k, km0), dev),
        *_view("a2", a2, (lanes, k, km - km0), dev), km0, *table[:4],
        out.data_ptr(), lanes, k, km, nm, OPS[op], gamma, split,
        *b0, *b1, *w0, *w1, *x0, *x1)
    if lanes * k and nm:
        with torch.cuda.device(dev):
            kernels.launch(kernels.lib("spmv").eicos_spmv, args,
                           kernels.stream(a))
        kernels.count("spmv")
    return out


def spmv(a: torch.Tensor, colptr: torch.Tensor, rows: torch.Tensor,
         vals: torch.Tensor, nm: int, a2: torch.Tensor = None, base=None,
         op: str = "add", w=None, gamma: float = 0.0, x=None,
         split: int = None) -> torch.Tensor:
    """On the card: acc[l, r, j] = sum_t vals[l, t] [a | a2][l, r, rows[t]]
    over t in colptr[j]..colptr[j+1], in that order, and out =
    ``fused_tail(acc, base, op, w, gamma, x, split)`` in the same launch.
    ``a`` (L, k, km0) and ``a2`` (L, k, km - km0) or None, f64 views with
    unit column stride; ``colptr`` (nm + 1,) and ``rows`` (nnz,) int32,
    ``vals`` (nnz,) shared or (L, nnz) per lane; ``base``, ``w``, ``x``
    (L, k, nm) views, or with ``split`` pairs of (L, k, split) and (L, k,
    nm - split) views."""
    return _launch(a, a2, _table(colptr, rows, vals, nm, a.device), nm, base,
                   op, w, gamma, x, split)
