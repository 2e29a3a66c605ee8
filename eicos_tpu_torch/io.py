"""Problem serialization: the port of ``eicos_tpu.io``.  One compressed
.npz per problem with the reference's keys (``n p m l q G A c h b``), so a
file written by either package loads in the other, and the round trip is
exact.  Values are taken from NumPy arrays or CPU tensors."""

from __future__ import annotations

import numpy as np

from .problem import ProblemData, make_problem
from .structure import ProblemStructure


def save_problem(path: str, structure: ProblemStructure,
                 data: ProblemData) -> None:
    np.savez_compressed(
        path,
        n=structure.n, p=structure.p, m=structure.m, l=structure.l,
        q=np.asarray(structure.q, dtype=np.int64),
        G=np.asarray(data.G), A=np.asarray(data.A),
        c=np.asarray(data.c), h=np.asarray(data.h), b=np.asarray(data.b),
    )


def load_problem(path: str):
    """Returns (structure, data), the data as NumPy f64 arrays."""
    with np.load(path) as z:
        st = ProblemStructure.create(
            int(z["n"]), int(z["p"]), int(z["m"]), int(z["l"]),
            tuple(int(v) for v in z["q"]))
        data = make_problem(st, z["G"], z["A"], z["c"], z["h"], z["b"])
    return st, data
