"""The port's batched cone algebra against eicos_tpu.cones (vmapped over
lanes) on a mixed LP + SOC cone: every function within 1e-13 relative."""

import torch_threads  # noqa: F401  (one torch thread a worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eicos_tpu  # noqa: F401  (enables x64)
from eicos_tpu import cones as jc
from eicos_tpu.structure import ConeStructure as JCone

from eicos_tpu_torch import cones as pc
from eicos_tpu_torch.structure import ConeStructure

L, Q = 7, (3, 5)
LANES = 4
TOL = 1e-13


def interior(m, q, l, rng):
    v = rng.standard_normal(m)
    lp = np.abs(v[:l]) + 0.5
    soc = v[l:].copy()
    off = 0
    for d in q:
        soc[off] = np.linalg.norm(soc[off + 1:off + d]) + 0.5 + abs(soc[off])
        off += d
    return np.concatenate([lp, soc])


@pytest.fixture(scope="module")
def data():
    jst, st = JCone(l=L, q=Q), ConeStructure(l=L, q=Q)
    m = st.m
    rng = np.random.default_rng(11)
    s = np.stack([interior(m, Q, L, rng) for _ in range(LANES)])
    z = np.stack([interior(m, Q, L, rng) for _ in range(LANES)])
    u = rng.standard_normal((LANES, m))
    v = rng.standard_normal((LANES, m))
    tau = rng.random(LANES) + 0.5
    dtau = rng.standard_normal(LANES)
    kap = rng.random(LANES) + 0.5
    dkap = rng.standard_normal(LANES)
    jscal, jlam = jax.vmap(lambda a, b: jc.update_scalings(jst, a, b))(
        jnp.asarray(s), jnp.asarray(z))
    scal, lam = pc.update_scalings(st, torch.tensor(s), torch.tensor(z))
    return dict(jst=jst, st=st, s=s, z=z, u=u, v=v, tau=tau, dtau=dtau,
                kap=kap, dkap=dkap, jscal=jscal, jlam=jlam, scal=scal,
                lam=lam)


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err < TOL, err


def test_update_scalings(data):
    for f in data["jscal"]._fields:
        close(getattr(data["scal"], f), getattr(data["jscal"], f))
    close(data["lam"], data["jlam"])


def _vec(name, fn_j, fn_p):
    def test(data):
        jst, st = data["jst"], data["st"]
        u, jscal, scal = data["u"], data["jscal"], data["scal"]
        want = jax.vmap(lambda sc, x: fn_j(jst, sc, x))(jscal, jnp.asarray(u))
        close(fn_p(st, scal, torch.tensor(u)), want)
    test.__name__ = f"test_{name}"
    return test


test_scale = _vec("scale", jc.scale, pc.scale)
test_scale2 = _vec("scale2", jc.scale2, pc.scale2)
test_scale2_inv = _vec("scale2_inv", jc.scale2_inv, pc.scale2_inv)
test_scale2reg_inv = _vec(
    "scale2reg_inv", lambda st, sc, x: jc.scale2reg_inv(st, sc, 7e-8, x),
    lambda st, sc, x: pc.scale2reg_inv(st, sc, 7e-8, x))


def test_scale2_takes_stacked_columns(data):
    """Refinement applies W^2 to (lanes, k, m) stacks."""
    st, scal = data["st"], data["scal"]
    u = torch.tensor(np.stack([data["u"], data["v"]], 1))
    got = pc.scale2(st, scal, u)
    for j in range(2):
        close(got[:, j], pc.scale2(st, scal, u[:, j]))


def test_conic_product(data):
    jst, st = data["jst"], data["st"]
    w, mu = jax.vmap(lambda a, b: jc.conic_product(jst, a, b))(
        jnp.asarray(data["u"]), jnp.asarray(data["v"]))
    pw, pmu = pc.conic_product(st, torch.tensor(data["u"]),
                               torch.tensor(data["v"]))
    close(pw, w)
    close(pmu, mu)


def test_conic_division(data):
    jst, st = data["jst"], data["st"]
    want = jax.vmap(lambda a, b: jc.conic_division(jst, a, b))(
        jnp.asarray(data["s"]), jnp.asarray(data["v"]))
    close(pc.conic_division(st, torch.tensor(data["s"]),
                            torch.tensor(data["v"])), want)


def test_line_search(data):
    jst, st = data["jst"], data["st"]
    args = [data[k] for k in ("u", "v", "tau", "dtau", "kap", "dkap")]
    want = jax.vmap(lambda lam, a, b, t, dt, k, dk: jc.line_search(
        jst, lam, a, b, t, dt, k, dk, 1e-6, 0.999))(
        data["jlam"], *[jnp.asarray(a) for a in args])
    got = pc.line_search(st, data["lam"], *[torch.tensor(a) for a in args],
                         1e-6, 0.999)
    close(got, want)


@pytest.mark.parametrize("which", ["u", "s"])
def test_bring_to_cone(data, which):
    jst, st = data["jst"], data["st"]
    r = data[which]
    want = jax.vmap(lambda x: jc.bring_to_cone(jst, x, 0.99))(jnp.asarray(r))
    close(pc.bring_to_cone(st, torch.tensor(r), 0.99), want)


def test_w2_dense(data):
    jst, st = data["jst"], data["st"]
    want = jax.vmap(lambda sc: jc.w2_dense(jst, sc, jnp.float64))(
        data["jscal"])
    close(pc.w2_dense(st, data["scal"]), want)


def test_lp_only_cone(data):
    """An LP-only cone takes the SOC-free branches."""
    jst, st = JCone(l=5, q=()), ConeStructure(l=5, q=())
    rng = np.random.default_rng(2)
    s, z = rng.random((LANES, 5)) + 0.1, rng.random((LANES, 5)) + 0.1
    jscal, jlam = jax.vmap(lambda a, b: jc.update_scalings(jst, a, b))(
        jnp.asarray(s), jnp.asarray(z))
    scal, lam = pc.update_scalings(st, torch.tensor(s), torch.tensor(z))
    close(lam, jlam)
    close(pc.scale2(st, scal, torch.tensor(s)),
          jax.vmap(lambda sc, x: jc.scale2(jst, sc, x))(jscal, jnp.asarray(s)))


# ----------------------------------- the card's cone kernels, on the host

CONE_KERNELS = ("cone_scalings", "cone_eig", "cone_rotate",
                "cone_line_search")


def test_cone_kernel_counts_stay_zero_on_cpu(data):
    """``kernels.COUNTS`` has a counter for each cone kernel; the CPU
    tensors of the cone functions take the plain twins and count nothing;
    ``reset_counts`` zeroes them with the others."""
    from eicos_tpu_torch import kkt
    from eicos_tpu_torch.ops import kernels

    kernels.reset_counts()
    st, case = data["st"], _host_case(L, Q, LANES, 3, None)
    pc.update_scalings(st, torch.tensor(data["s"]), torch.tensor(data["z"]))
    pc.line_search(st, data["lam"], *[torch.tensor(data[k]) for k in (
        "u", "v", "tau", "dtau", "kap", "dkap")], 1e-6, 0.999)
    rot, _ = kkt._soc_eig(case["ctx"], case["scal"], 1e-7)
    kkt._soc_rotate(rot, case["x"], case["ctx"])
    assert {n: kernels.COUNTS[n] for n in CONE_KERNELS} == dict.fromkeys(
        CONE_KERNELS, 0)
    for n in CONE_KERNELS:
        kernels.COUNTS[n] = 3
    kernels.reset_counts()
    assert all(kernels.COUNTS[n] == 0 for n in CONE_KERNELS)


def _c_functions(src):
    """{name: parameter count} of the ``extern "C"`` functions in ``src``."""
    import re

    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
        out[m.group(1)] = len(m.group(2).split(","))
    return out


def test_cones_lib_binds_what_the_source_exports():
    """``kernels.LIBS["cones"]`` names each entry point that
    ``csrc/cones.cu`` exports, with one argument type a parameter, and its
    wrappers call each of them."""
    import inspect
    import os

    from eicos_tpu_torch.ops import kernels, soc

    source, symbols = kernels.LIBS["cones"]
    with open(os.path.join(kernels.CSRC, source)) as fh:
        exported = _c_functions(fh.read())
    assert exported == {name: len(types) for name, types in symbols.items()}
    called = inspect.getsource(soc)
    for name in CONE_KERNELS:
        assert f'"{name}"' in called and f"eicos_{name}" in symbols


@pytest.fixture(scope="module")
def host_cones(tmp_path_factory):
    """``csrc/cones.cu`` built for the host (a host C++ compiler, each
    operation rounded on its own: -ffp-contract=off), bound as
    ``kernels.lib`` binds the card's build."""
    import ctypes
    import os
    import shutil
    import subprocess

    from eicos_tpu_torch.ops import kernels

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    source, symbols = kernels.LIBS["cones"]
    lib = tmp_path_factory.mktemp("host_cones") / "cones.so"
    subprocess.run([cxx, "-x", "c++", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(lib),
                    os.path.join(kernels.CSRC, source)], check=True)
    cdll = ctypes.CDLL(str(lib))
    for sym, argtypes in symbols.items():
        getattr(cdll, sym).argtypes = argtypes
        getattr(cdll, sym).restype = ctypes.c_int
    return cdll


@pytest.fixture
def on_host(host_cones, monkeypatch):
    """Inside the block, the cone functions of ``cones`` and ``kkt`` take
    their kernels' path on CPU tensors, launching the host build."""
    import contextlib

    from eicos_tpu_torch.ops import kernels

    @contextlib.contextmanager
    def block():
        with monkeypatch.context() as mp:
            mp.setattr(kernels, "on_cpu", lambda t: False)
            mp.setattr(kernels, "lib", lambda name: host_cones)
            mp.setattr(kernels, "stream", lambda t: None)
            mp.setattr(torch.cuda, "device",
                       lambda dev: contextlib.nullcontext())
            yield
    return block


def _ieee_sqrt(x):
    """A correctly rounded square root, as the card's (torch's CPU kernel
    rounds some f64 square roots the other way)."""
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.sqrt(x.numpy()))


def _host_case(l, q, lanes, seed, kind):
    """Plain-path inputs on the CPU: interior s, z (``kind`` "q0": z = s on
    cone 0, so its q is 0; "outside": lane 1's cone 0 out of its cone),
    their scalings, a context with G_soc (per lane for "mixed"), the
    rotation's right-hand sides and the line search's arguments, with cone
    0 of lane 0 outside lam's cone and tau (lane 0) and kappa (the last
    lane) steps that bind."""
    from eicos_tpu_torch import kkt

    st = ConeStructure(l=l, q=q)
    rng = np.random.default_rng(seed)
    m, ms, n_sc = st.m, st.ms, st.n_sc
    s = np.stack([interior(m, q, l, rng) for _ in range(lanes)])
    z = np.stack([interior(m, q, l, rng) for _ in range(lanes)])
    if kind == "q0":
        z[:, l:l + q[0]] = s[:, l:l + q[0]]
    elif kind == "outside":
        s[1, l] = -3.0
    s, z = torch.tensor(s), torch.tensor(z)
    scal, lam = pc.update_scalings(st, s, z)
    qidx, valid = kkt._soc_pad_maps(q, ms)
    D, w = qidx.shape[1], 3
    sm = kkt.SocMaps(
        qidx=torch.tensor(qidx), valid=torch.tensor(valid),
        head=torch.tensor((np.arange(D)[None, :] == 0) & valid),
        cols=torch.zeros(n_sc, w, dtype=torch.int64),
        flat=torch.tensor(np.flatnonzero(valid)),
        offs=torch.tensor(np.append(st.head_offsets, ms), dtype=torch.int32))
    gshape = ((lanes,) if kind == "mixed" else ()) + (n_sc, D, w)
    gsub = torch.tensor(rng.standard_normal(gshape) * valid[:, :, None])
    G = torch.zeros(1, 1, dtype=torch.float64)
    ctx = kkt.KKTContext(G=G, A=G, Gf=G, split=None, spr_outer=None,
                         sing_sq=None, soc=sm, soc_gsub=gsub)
    lam_ls = lam.clone()
    lam_ls[0, l] = -5.0
    tau, kap = (torch.tensor(rng.random(lanes) + 0.5) for _ in range(2))
    dtau, dkap = (torch.tensor(rng.standard_normal(lanes)) for _ in range(2))
    dtau[0], dkap[-1] = -1e3, -1e3
    return dict(st=st, s=s, z=z, scal=scal, lam=lam, ctx=ctx,
                x=torch.tensor(rng.standard_normal((lanes, 2, ms))),
                ls=(lam_ls, torch.tensor(rng.standard_normal((lanes, m))),
                    torch.tensor(rng.standard_normal((lanes, m))), tau, dtau,
                    kap, dkap))


def _held(got, want, bits):
    """NaN in the same entries, and elsewhere the same bits (``bits``) or
    within 1e-15 in 2-norm, relative."""
    got, want = got.contiguous(), want.contiguous()
    assert got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    g, w = got[~nan], want[~nan]
    if bits:
        assert torch.equal(g.view(torch.int64), w.view(torch.int64))
    else:
        assert float((g - w).norm()) <= 1e-15 * float(w.norm())


def _counted(name, fn, *args):
    from eicos_tpu_torch.ops import kernels

    before = kernels.COUNTS[name]
    out = fn(*args)
    assert kernels.COUNTS[name] == before + 1
    return out


HOST_CASES = {"pdg": (5, (4, 3, 3) * 6, None), "q0": (5, (4, 3, 3) * 2, "q0"),
              "outside": (5, (4, 3, 3) * 2, "outside"),
              "mixed": (7, (1, 2, 5, 40), "mixed")}


@pytest.mark.parametrize("name", list(HOST_CASES))
def test_host_cone_scalings_match_plain(on_host, monkeypatch, name):
    """``cone_scalings``, built for the host and called through
    ``update_scalings`` on strided s and z (one launch), against its torch
    code with IEEE square roots: the same bits while the plain sums run in
    ``segsum``'s fixed order (cones of at most 16 entries), within 1e-15
    past it (the 40-entry cone)."""
    monkeypatch.setattr(torch, "sqrt", _ieee_sqrt)
    l, q, kind = HOST_CASES[name]
    c = _host_case(l, q, 6, 7, kind)
    st, (lanes, m) = c["st"], c["s"].shape
    wide = torch.zeros(2, lanes, m + 3, dtype=torch.float64)
    wide[:, :, 2:m + 2] = torch.stack([c["s"], c["z"]])
    with on_host():
        scal, lam = _counted("cone_scalings", pc.update_scalings, st,
                             wide[0, :, 2:m + 2], wide[1, :, 2:m + 2])
    for got, want in zip((*scal, lam), (*c["scal"], c["lam"])):
        _held(got, want, max(q) <= 16)


@pytest.mark.parametrize("name", list(HOST_CASES))
def test_host_cone_eig_and_rotate_match_plain(on_host, monkeypatch, name):
    """``cone_eig`` (one launch: rot, lam, the kept blocks, the coupling)
    and ``cone_rotate`` (both orientations, two right-hand sides of a
    strided view), built for the host and called through ``kkt``, against
    ``_soc_eig``, ``_soc_kept_vals``, ``_soc_coupling_vals`` and
    ``_soc_rotate``: within 1e-15 (their plain sums are a library's), NaN
    in the same entries."""
    from eicos_tpu_torch import kkt

    monkeypatch.setattr(torch, "sqrt", _ieee_sqrt)
    l, q, kind = HOST_CASES[name]
    c = _host_case(l, q, 6, 8, kind)
    st, ctx, scal = c["st"], c["ctx"], c["scal"]
    lanes, delta = c["s"].shape[0], 7e-8
    eig = kkt._soc_eig(ctx, scal)
    want = (*eig, kkt._soc_kept_vals(st, ctx, scal, delta, lanes, eig),
            kkt._soc_coupling_vals(ctx, eig, lanes))
    ms = st.ms
    wide = torch.zeros(lanes, 2, ms + 5, dtype=torch.float64)
    wide[:, :, 1:ms + 1] = c["x"]
    with on_host():
        got = _counted("cone_eig", kkt._soc_eig, ctx, scal, delta)
        assert kkt._soc_kept_vals(st, ctx, scal, delta, lanes, got) is got[2]
        assert kkt._soc_coupling_vals(ctx, got, lanes) is got[3]
        ys = [_counted("cone_rotate", kkt._soc_rotate, got[0],
                       wide[:, :, 1:ms + 1], ctx, t) for t in (False, True)]
    for g, w in zip(got, want):
        _held(g, w, False)
    for y, t in zip(ys, (False, True)):
        _held(y, kkt._soc_rotate(eig[0], c["x"], ctx, t), False)


@pytest.mark.parametrize("name", list(HOST_CASES))
def test_host_cone_line_search_matches_plain(on_host, monkeypatch, name):
    """``cone_line_search``, built for the host and called through
    ``line_search`` with strided tau and kappa (one launch), against its
    torch code with IEEE square roots, with a cone outside lam's cone
    (skipped) and binding tau and kappa steps: the same bits up to 16
    entries a cone, within 1e-15 past it."""
    monkeypatch.setattr(torch, "sqrt", _ieee_sqrt)
    l, q, kind = HOST_CASES[name]
    c = _host_case(l, q, 6, 9, kind)
    lam, ds, dz, tau, dtau, kap, dkap = c["ls"]
    want = pc.line_search(c["st"], *c["ls"], 1e-6, 0.999)
    assert float(want[0]) == float(tau[0]) / 1e3         # tau binds
    assert float(want[-1]) == float(kap[-1]) / 1e3       # kappa binds
    tk = torch.stack([tau, kap], 1)
    with on_host():
        got = _counted("cone_line_search", pc.line_search, c["st"], lam, ds,
                       dz, tk[:, 0], dtau, tk[:, 1], dkap, 1e-6, 0.999)
    _held(got, want, max(q) <= 16)
