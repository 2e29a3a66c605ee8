"""The plain reference on problems whose answers are known."""

import numpy as np

from reference import certificate


def lp():
    """min x1 + 2 x2  s.t.  x1 + x2 = 1, x >= 0: x = (1, 0), y = -1,
    z = (0, 1), s = x."""
    G = -np.eye(2)
    A = np.array([[1.0, 1.0]])
    c = np.array([[1.0, 2.0]])
    h = np.zeros(2)
    b = np.array([[1.0]])
    ans = dict(x=np.array([[1.0, 0.0]]), y=np.array([[-1.0]]),
               z=np.array([[0.0, 1.0]]), s=np.array([[1.0, 0.0]]))
    return (G, A, c, h, b, 2, ()), ans


def socp():
    """min t  s.t.  ||(1, 1)|| <= t: t = sqrt 2, s = (t, 1, 1),
    z = (1, -1/sqrt 2, -1/sqrt 2)."""
    r = np.sqrt(2.0)
    G = np.array([[-1.0], [0.0], [0.0]])
    A = np.zeros((0, 1))
    c = np.array([[1.0]])
    h = np.array([0.0, 1.0, 1.0])
    b = np.zeros((1, 0))
    ans = dict(x=np.array([[r]]), y=np.zeros((1, 0)),
               z=np.array([[1.0, -1 / r, -1 / r]]),
               s=np.array([[r, 1.0, 1.0]]))
    return (G, A, c, h, b, 0, (3,)), ans


def test_known_answers_read_zero():
    for prob, ans in (lp(), socp()):
        r = certificate.readings(*prob, **ans)
        for name in certificate.READINGS:
            assert r[name].shape == (1,)
            assert r[name][0] <= 1e-15, name


def test_each_reading_catches_its_fault():
    prob, ans = lp()
    bad = dict(ans, x=ans["x"] + [[1e-3, 0.0]])
    assert certificate.readings(*prob, **bad)["pres"][0] > 1e-4
    bad = dict(ans, y=ans["y"] + 1e-3)
    assert certificate.readings(*prob, **bad)["dres"][0] > 1e-4
    # a feasible pair with the wrong dual: x and s right, y and z feasible
    # for the dual but not optimal
    bad = dict(ans, y=np.array([[-0.5]]), z=np.array([[0.5, 1.5]]))
    r = certificate.readings(*prob, **bad)
    assert r["dres"][0] <= 1e-15 and r["gap"][0] > 0.1
    bad = dict(ans, s=np.array([[1.0, -1e-3]]), x=np.array([[1.0, 1e-3]]))
    assert certificate.readings(*prob, **bad)["cone"][0] > 1e-4
    prob, ans = socp()
    bad = dict(ans, z=np.array([[1.0, -1.0, -1.0]]))
    assert certificate.readings(*prob, **bad)["cone"][0] > 0.1


def test_lanes_are_read_one_by_one():
    prob, ans = lp()
    G, A, c, h, b, l, q = prob
    two = {k: np.concatenate([v, v]) for k, v in ans.items()}
    two["x"] = two["x"].copy()
    two["x"][1, 0] += 1e-2
    r = certificate.readings(G, A, np.concatenate([c, c]), h,
                             np.concatenate([b, b]), l, q, **two)
    assert r["pres"][0] <= 1e-15 < r["pres"][1]
