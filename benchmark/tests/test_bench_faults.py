"""A run with the timed path broken underneath must come out not
correct: once for each fault the cells can have.  (They run on one card:
no exchange between cards can be left out.)"""

import pytest
import torch

import harness
from conftest import tiny

CELLS = ("mpc_lp.sweep128", "mpc_lp.tick16")


def broken(monkeypatch, fault):
    import eicos_tpu_torch as pt

    real = pt.BatchedSolver.solve
    first = {}

    def solve(bs, *args, **kw):
        sol = real(bs, *args, **kw)
        if fault == "unchanged":
            # a step that returns its state unchanged: the first answer
            # ever made, whatever the batch
            return first.setdefault("sol", sol)
        if fault == "half":
            # half of the batch left out: its lanes take the other half's
            half = sol.x.shape[0] // 2
            idx = torch.arange(sol.x.shape[0]) % half
            return type(sol)(*[v[idx] if isinstance(v, torch.Tensor)
                               else type(v)(*[w[idx] for w in v])
                               for v in sol])
        if fault == "altered":
            # one answer altered where it is produced
            x = sol.x.clone()
            x[-1, 0] += 1e-3
            return sol._replace(x=x)
        if fault == "dual_altered":
            # one lane's dual answer altered where it is produced, in a row
            # whose b is 0, so that only the dual residual sees it
            y = sol.y.clone()
            y[-1, -1] += 1e-3
            return sol._replace(y=y)
        if fault == "rescued_altered":
            # a lane that the rescue answered, its answer altered: every
            # batch in which the rescue answered a lane is compared
            bs.last_rescued = (1,)
            x = sol.x.clone()
            x[1, 0] += 1e-3
            return sol._replace(x=x)
        raise ValueError(fault)

    monkeypatch.setattr(pt.BatchedSolver, "solve", solve)


@pytest.mark.parametrize("fault", ("unchanged", "half", "altered",
                                   "dual_altered", "rescued_altered"))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    broken(monkeypatch, fault)
    share = 0.0 if fault == "rescued_altered" else 1.0
    spec = tiny(cell, check_share=share)
    result, run = harness.execute(spec, 7, 0.5, False, device="cpu")
    assert not result["correct"]
    failing = [k for k, c in result["checks"].items()
               if not c["value"] <= c["limit"]]
    assert failing and result["failed"] > 0
    if fault == "rescued_altered":
        # no batch is sampled: the rescue's alone are compared
        assert set(run.kept) == {spec["traffic"]["warm"] + j
                                 for j in range(len(run.batches))}
        assert "pres" in failing
    if fault == "dual_altered":
        assert failing == ["dres"]
