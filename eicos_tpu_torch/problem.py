"""Problem values: dense G (m, n), A (p, n), c, h, b.

``ProblemData`` holds NumPy arrays or torch tensors; a batch carries a
leading lane axis on the fields that vary per lane (``api.BatchedSolver``
names the shared ones).  ``from_reference`` rebuilds the JAX package's
structure and data in the port, so that both packages solve the identical
instance, and ``scaling_from_reference`` its Nesterov-Todd scalings.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from .structure import (ConeStructure, GSplit, MatvecPattern,
                        ProblemStructure, SOCSplit)


@dataclasses.dataclass(frozen=True)
class ProblemData:
    """Values of one SOCP (or a batch, with a leading lane axis)."""

    G: Any  # (m, n)
    A: Any  # (p, n)
    c: Any  # (n,)
    h: Any  # (m,)
    b: Any  # (p,)


def densify(mat, shape, dtype=np.float64) -> np.ndarray:
    """Accept scipy.sparse, dense, or None."""
    if mat is None:
        return np.zeros(shape, dtype=dtype)
    if hasattr(mat, "toarray"):  # scipy.sparse
        out = np.asarray(mat.toarray(), dtype=dtype)
    else:
        out = np.asarray(mat, dtype=dtype)
    if out.shape != shape:
        raise ValueError(f"expected shape {shape}, got {out.shape}")
    return out


def make_problem(structure: ProblemStructure, G, A, c, h, b,
                 dtype=np.float64) -> ProblemData:
    n, p, m = structure.n, structure.p, structure.m
    return ProblemData(
        G=densify(G, (m, n), dtype),
        A=densify(A, (p, n), dtype),
        c=np.zeros(n, dtype) if c is None else np.asarray(c, dtype).reshape(n),
        h=np.zeros(m, dtype) if h is None else np.asarray(h, dtype).reshape(m),
        b=np.zeros(p, dtype) if b is None else np.asarray(b, dtype).reshape(p),
    )


def structure_fields(st) -> dict:
    """Plain fields (ints, tuples) of a ``ProblemStructure`` of either
    package: the input of ``from_reference``."""
    out = dict(n=int(st.n), p=int(st.p), l=int(st.l),
               q=tuple(int(d) for d in st.q))
    if st.band is not None:
        out["band"] = dict(perm=tuple(int(v) for v in st.band.perm),
                           bwb=int(st.band.bwb), block=int(st.band.block),
                           keep_soc=bool(getattr(st.band, "keep_soc",
                                                 False)))
    for name in ("gsplit", "socsplit", "matvec"):
        obj = getattr(st, name)
        if obj is not None:
            out[name] = {f.name: getattr(obj, f.name)
                         for f in dataclasses.fields(obj)}
    return out


def from_reference(fields: dict, G, A, c, h, b):
    """Build the port's (structure, data) from the JAX package's
    ``ProblemStructure`` fields (``structure_fields``) and ``ProblemData``
    values as NumPy arrays.  The symbolic plans are taken as given, not
    recomputed, so both packages factor in the same order."""
    from .plan import BandPlan

    st = ProblemStructure(n=fields["n"], p=fields["p"],
                          cone=ConeStructure(l=fields["l"], q=fields["q"]))
    repl = {}
    if "band" in fields:
        repl["band"] = BandPlan(**fields["band"])
    if "gsplit" in fields:
        repl["gsplit"] = GSplit(**fields["gsplit"])
    if "socsplit" in fields:
        repl["socsplit"] = SOCSplit(**fields["socsplit"])
    if "matvec" in fields:
        repl["matvec"] = MatvecPattern(**fields["matvec"])
    st = dataclasses.replace(st, **repl)
    return st, ProblemData(G=np.asarray(G, np.float64),
                           A=np.asarray(A, np.float64),
                           c=np.asarray(c, np.float64),
                           h=np.asarray(h, np.float64),
                           b=np.asarray(b, np.float64))


def scaling_from_reference(scalings, device="cpu"):
    """The port's ``cones.Scaling`` from the JAX package's per-lane
    ``cones.Scaling`` tuples (one per lane, fields as NumPy arrays), lanes
    stacked along a new leading axis."""
    import torch

    from .cones import Scaling

    return Scaling(*[
        torch.as_tensor(np.stack([np.asarray(getattr(sc, f), np.float64)
                                  for sc in scalings]), device=device)
        for f in Scaling._fields])
