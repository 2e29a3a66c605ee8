"""The work of the band factor at any block bandwidth: the bytes and f64
operations of the block-banded LDL^T that ``band.factor_roofline`` holds
the stamped time of a factor against.  At bandwidth 1 it is
``frozen.band_factor_work``, counted the same way."""

from __future__ import annotations

from frozen import B


def band_factor_work_bw(lanes, nb, bw):
    """(bytes, operations) of the LDL^T of ``nb`` 128-blocks a lane at
    block bandwidth ``bw``: each input block read once and each output
    written once (Kd and the bw sub-diagonal blocks of every block row
    in, as many L blocks and Dinv out; d); in block row k, with mk =
    min(bw, k) blocks left of the diagonal, mk (mk - 1) / 2 general
    corrections of a block (2 B^3 each), mk products with the unit-lower
    Dinv and mk symmetric Schur updates (B^3 each), then the leaf (B^3 /
    2) and the unit-lower inverse (B^3 / 3)."""
    blk = B * B * 8
    nbytes = lanes * nb * ((2 + 2 * bw) * blk + B * 8)
    ops = lanes * sum(
        (min(bw, k) * (min(bw, k) - 1) + 2 * min(bw, k)) * B ** 3
        + B ** 3 // 2 + B ** 3 // 3 for k in range(nb))
    return nbytes, ops
