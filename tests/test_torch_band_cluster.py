"""The band factor's choice of CTAs a lane (``ops/band.cluster_size``): a
pure function of the lane count, the block bandwidth, the card's SM count
and the clusters the card holds at once, so it is held here on the CPU;
the cluster kernel itself is held to the one-CTA kernel's bits in
``tests/test_torch_cuda.py``."""

import torch_threads  # noqa: F401  (one torch thread a worker)

import numpy as np
import pytest
import torch

from eicos_tpu_torch.ops import band
from eicos_tpu_torch.ops.band_ldl import band_factor_bw_plain

H100 = dict(sms=132, active={8: 16, 4: 33, 2: 66})


@pytest.mark.parametrize("lanes,bw,active,c", [
    (16, 1, None, 8),                   # the tick: 128 of 132 SMs
    (1, 1, None, 8),
    (4, 1, None, 8),
    (17, 1, None, 4),                   # 17 x 8 > 132
    (32, 1, None, 4),
    (33, 1, None, 4),
    (34, 1, None, 2),                   # 34 x 4 > 132
    (64, 1, None, 2),
    (66, 1, None, 2),
    (67, 1, None, 1),                   # 67 x 2 > 132: one CTA a lane
    (128, 1, None, 1),
    (16, 3, None, 1),                   # bw 3: the wide kernel
    (1, 2, None, 1),
    (16, 1, {8: 14, 4: 33, 2: 66}, 4),  # 14 clusters of 8 < 16 lanes
    (16, 1, {8: 14, 4: 15, 2: 66}, 2),
    (16, 1, {8: 0, 4: 0, 2: 0}, 1),     # a card that holds no cluster
], ids=lambda v: str(v).replace(" ", ""))
def test_cluster_size_rule(lanes, bw, active, c):
    got = band.cluster_size(lanes, bw, H100["sms"],
                            H100["active"] if active is None else active)
    assert got == c


def test_cluster_size_needs_the_sms():
    """Fewer SMs than lanes x c steps down whatever the occupancy says."""
    many = {8: 99, 4: 99, 2: 99}
    assert band.cluster_size(16, 1, 127, many) == 4
    assert band.cluster_size(16, 1, 31, many) == 1


def test_cpu_factor_never_asks_the_card(monkeypatch):
    """A CPU tensor takes the plain twin: the wrapper neither asks the card
    for its clusters nor counts a launch."""
    from eicos_tpu_torch.ops import kernels

    def card(index):
        raise AssertionError("asked the card")

    monkeypatch.setattr(band, "_card", card)
    rng = np.random.default_rng(0)
    Kd = torch.tensor(rng.standard_normal((2, 3, 128, 128)))
    Kd = Kd + Kd.transpose(-1, -2) + 300 * torch.eye(128, dtype=Kd.dtype)
    Ks = torch.tensor(rng.standard_normal((2, 3, 1, 128, 128)))
    before = dict(kernels.COUNTS)
    fac = band.band_factor(Kd, Ks)
    ref = band_factor_bw_plain(Kd, Ks)
    assert all(torch.equal(a, b) for a, b in zip(fac, ref))
    wide = band.band_factor_bw(Kd, Ks)
    assert all(torch.equal(a, b) for a, b in zip(wide, ref))
    assert kernels.COUNTS == before
