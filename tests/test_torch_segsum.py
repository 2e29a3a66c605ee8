"""The port's fixed-order segment sums (eicos_tpu_torch/segsum.py) against
``index_add_`` into zeros on the CPU: the same bits up to SEQUENTIAL_MAX
contributions to a target (the same sequential order), and within 1e-14
relative beyond it (a fixed but different order)."""

import numpy as np
import pytest
import torch

from eicos_tpu_torch import cones
from eicos_tpu_torch.segsum import SEQUENTIAL_MAX, segment_map, segment_sum
from eicos_tpu_torch.structure import ConeStructure


def scattered(idx, vals, size, keep=None):
    """(index_add_ reference, segment sums written into zeros)."""
    sel = np.ones(len(idx), bool) if keep is None else keep
    ref = vals.new_zeros(vals.shape[0], size).index_add_(
        1, torch.as_tensor(idx[sel]), vals[:, torch.as_tensor(sel)])
    seg = segment_map(idx, "cpu", keep)
    out = vals.new_zeros(vals.shape[0], size)
    out[:, seg.targets] = segment_sum(seg, vals)
    return ref, out


@pytest.mark.parametrize("mult", [1, 3, 8, SEQUENTIAL_MAX])
@pytest.mark.parametrize("use_keep", [False, True])
def test_segment_sum_same_bits_as_index_add(mult, use_keep):
    rng = np.random.default_rng(mult)
    size = 50
    idx = np.repeat(rng.permutation(size)[:20], mult)[rng.permutation(
        20 * mult)]
    vals = torch.tensor(rng.standard_normal((3, idx.size))
                        * 10.0 ** rng.integers(-8, 8, (3, idx.size)))
    keep = rng.random(idx.size) < 0.7 if use_keep else None
    ref, out = scattered(idx, vals, size, keep)
    assert torch.equal(ref, out)


def test_segment_sum_beyond_sequential_max():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 3, 40 * 3)
    idx[:SEQUENTIAL_MAX + 1] = 0
    vals = torch.tensor(rng.standard_normal((2, idx.size)))
    ref, out = scattered(idx, vals, 3)
    assert float((ref - out).abs().max() / ref.abs().max()) < 1e-14


def test_segment_sum_empty_map():
    seg = segment_map(np.zeros(0, np.int64), "cpu")
    assert seg.targets.numel() == 0
    assert segment_sum(seg, torch.zeros(4, 0, dtype=torch.float64)).shape \
        == (4, 0)


def test_cone_seg_sum_same_bits_as_index_add():
    """The per-cone sums of ``cones`` over cones of 3, 5 and 4 entries,
    with a lane axis and a (lanes, k, ms) stack."""
    st = ConeStructure(l=2, q=(3, 5, 4))
    seg = torch.as_tensor(st.seg, dtype=torch.int64)
    rng = np.random.default_rng(3)
    for shape in ((4, st.ms), (4, 2, st.ms)):
        x = torch.tensor(rng.standard_normal(shape))
        ref = x.new_zeros(*shape[:-1], st.n_sc).index_add_(x.dim() - 1, seg,
                                                           x)
        assert torch.equal(cones.seg_sum(st, x), ref)
