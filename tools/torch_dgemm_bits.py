"""The port's ``dgemm`` kernel on seeded inputs in its forms (per lane,
shared operand, transposed, ragged, unaligned, the structure flags), saved
to a file, or two such files compared bit for bit: whether two source trees
give the same bits.  Needs a CUDA card.

    python3 tools/torch_dgemm_bits.py save OUT.pt      # from a checkout's root
    python3 tools/torch_dgemm_bits.py compare A.pt B.pt
"""

import os
import sys


def forms(torch, gemm):
    g = torch.Generator(device="cuda")
    g.manual_seed(11)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64,
                           device="cuda")

    L, h = 8, 384
    a, b, c = rnd(L, h, h), rnd(L, h, h), rnd(L, h, h)
    tri = torch.tril(rnd(L, h, h))
    big = rnd(L, 2 * h + 1, 2 * h + 1)
    out = {
        "per_lane": gemm.matmul(a, b),
        "shared_b": gemm.matmul(rnd(L, 16, h), rnd(h, h)),
        "transposed": gemm.matmul(a, b.transpose(-1, -2), c=c.clone(),
                                  alpha=-1.0, beta=1.0),
        "ragged": gemm.matmul(rnd(L, 37, 150), rnd(L, 150, 77)),
        "unaligned": gemm.matmul(big[:, 1:h + 1, 1:h + 1], b),
        "c_lower": gemm.matmul(a, b.transpose(-1, -2), c=c.clone(),
                               alpha=-1.0, beta=1.0, c_lower=True),
        "b_upper": gemm.matmul(a, tri.transpose(-1, -2), b_tri="upper"),
        "b_lower": gemm.matmul(a, tri, b_tri="lower"),
        "a_lower": gemm.matmul(tri, a, alpha=-1.0, a_tri="lower"),
    }
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def main(argv):
    import torch

    if argv[:1] == ["save"] and len(argv) == 2:
        if not torch.cuda.is_available():
            sys.exit("needs a CUDA card")
        sys.path.insert(0, os.getcwd())
        from eicos_tpu_torch.ops import gemm

        torch.save(forms(torch, gemm), argv[1])
        return 0
    if argv[:1] == ["compare"] and len(argv) == 3:
        x, y = torch.load(argv[1]), torch.load(argv[2])
        same = {k: torch.equal(x[k], y[k]) for k in x}
        print(f"dgemm bits equal, form by form: {same}")
        return 0 if all(same.values()) and x.keys() == y.keys() else 1
    sys.exit(__doc__)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
