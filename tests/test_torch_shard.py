"""``parallel/sharding.py`` and ``BatchedSolver(mesh=)`` on a CPU mesh of
two devices: the lanes split evenly over the mesh, the shared fields go to
each device, each shard is solved as its own batch (at once, one thread a
device) and the solution is gathered on the first device.  The rescue is
not sharded."""

import torch_threads  # noqa: F401  (one torch thread a worker)

import numpy as np
import pytest
import torch

import eicos_tpu_torch as pt
from eicos_tpu_torch import corpus
from eicos_tpu_torch.parallel import make_mesh, solve_batch_sharded
from eicos_tpu_torch.plan import make_band_plan

SHARED = ("G", "A", "h")
CPU2 = [torch.device("cpu")] * 2


@pytest.fixture(scope="module")
def lanes():
    st, base = corpus.make_mpc_like(8, 2, 3, seed=1)
    st = st.with_gsplit(base.G, base.A)
    st = st.with_band_plan(make_band_plan(st, base.G, base.A))
    rng = np.random.default_rng(7)
    probs = []
    for _ in range(4):
        c = np.asarray(base.c) + 0.02 * rng.standard_normal(st.n)
        b = np.asarray(base.b).copy()
        b[:2] += 0.05 * rng.standard_normal(2)
        probs.append(pt.ProblemData(G=base.G, A=base.A, c=c, h=base.h, b=b))
    return st, probs


def same_bits(a, b):
    if isinstance(a, tuple):
        return all(same_bits(u, v) for u, v in zip(a, b))
    return torch.equal(torch.nan_to_num(a.double(), 7.0),
                       torch.nan_to_num(b.double(), 7.0)) and \
        a.dtype == b.dtype and torch.equal(a.isnan(), b.isnan())


def unsharded_halves(st, probs, settings, rescue=None):
    """Each half of the lanes solved as its own unsharded batch, joined."""
    sols = [pt.BatchedSolver(st, settings, shared=SHARED, rescue=rescue,
                             device="cpu").solve(pt.BatchedSolver.stack(
                                 probs[i:i + 2], shared=SHARED))
            for i in (0, 2)]

    def cat(u, v):
        if isinstance(u, tuple):
            return type(u)(*[cat(a, b) for a, b in zip(u, v)])
        return torch.cat([u, v])
    return cat(*sols)


@pytest.mark.parametrize("api", ["function", "solver"])
def test_sharded_solve_equals_unsharded(lanes, api):
    """Four lanes over two devices equal, bit for bit, each shard solved
    unsharded, and agree with the whole batch solved unsharded in exit
    code and iterations, with objectives within 1e-12 relative (a CPU
    BLAS sums a row of a product by an order that depends on the number
    of rows, so the two batch sizes differ in the last bits)."""
    st, probs = lanes
    cfg = pt.Settings(kkt_strategy="banded")
    batch = pt.BatchedSolver.stack(probs, shared=SHARED)
    if api == "function":
        sol = solve_batch_sharded(st, batch, CPU2, cfg, shared=SHARED)
    else:
        bs = pt.BatchedSolver(st, cfg, shared=SHARED, mesh=CPU2)
        assert bs.device == CPU2[0]
        sol = bs.solve(batch)
        assert same_bits(bs.solve(batch), sol)
    assert same_bits(sol, unsharded_halves(st, probs, cfg))
    whole = pt.BatchedSolver(st, cfg, shared=SHARED, device="cpu").solve(
        batch)
    assert torch.equal(sol.exit_code, whole.exit_code)
    assert torch.equal(sol.info.iter, whole.info.iter)
    assert torch.allclose(sol.info.pcost, whole.info.pcost, rtol=1e-12,
                          atol=0)


def test_sharded_rescue_is_unsharded(lanes):
    """A primary cut at 3 iterations fails every lane; the rescue solves
    the four lanes as one unsharded batch on the first device, so the
    result equals, bit for bit, the halves solved unsharded with their
    rescue where the rescue's lanes are taken, and every lane ends
    OPTIMAL."""
    st, probs = lanes
    cfg = pt.Settings(kkt_strategy="banded", iter_max=3)
    rescue = pt.Settings(kkt_strategy="reduced")
    batch = pt.BatchedSolver.stack(probs, shared=SHARED)
    bs = pt.BatchedSolver(st, cfg, shared=SHARED, rescue=rescue, mesh=CPU2)
    sol = bs.solve(batch)
    ref = pt.BatchedSolver(st, cfg, shared=SHARED, rescue=rescue,
                           device="cpu")
    want = ref.solve(batch)
    assert bs.last_rescued == ref.last_rescued == (0, 1, 2, 3)
    assert sol.exit_code.tolist() == [0] * 4
    # the rescue batch is the same four lanes on the same device
    assert same_bits(sol.x, want.x) and same_bits(sol.info, want.info)


def test_uneven_split_raises(lanes):
    st, probs = lanes
    batch = pt.BatchedSolver.stack(probs[:3], shared=SHARED)
    with pytest.raises(ValueError):
        solve_batch_sharded(st, batch, CPU2, pt.Settings(
            kkt_strategy="banded"), shared=SHARED)
    with pytest.raises(ValueError):
        pt.BatchedSolver(st, pt.Settings(kkt_strategy="banded"),
                         shared=SHARED, mesh=CPU2).solve(batch)


def test_make_mesh_counts_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh() == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_mesh(1) == (torch.device("cuda", 0),)
    with pytest.raises(RuntimeError):
        make_mesh(3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError):
        make_mesh()
