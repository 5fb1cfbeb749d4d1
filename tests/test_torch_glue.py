"""The BiCGSTABwr iteration's vector glue (``ops/glue_cuda.py``): the plain
version, :class:`TorchGlue`, against the iteration's torch expressions as
``solvers/bicgstab.py`` wrote them before the glue had a module of its own
(copied below, frozen), bit for bit, piece by piece (``s``, ``xr``, ``p``)
and through whole solves of the per-iteration host loop; and the route
rule, :func:`glue_route`, which sends a solve to the glue kernels
(``csrc/solver_glue.cu``) only on one card at float32.  The kernels
themselves run on the card (chip_smoke.py's glue phase)."""

import pytest
import torch

from eddy_currents_3d_tpu_torch.assembly.stencil import State
from eddy_currents_3d_tpu_torch.ops.glue_cuda import (FLAGS, SCALARS,
                                                      TorchGlue, glue_route,
                                                      solver_glue)
from eddy_currents_3d_tpu_torch.solvers import bicgstab as bs

torch.set_num_threads(2)

SHAPE = (6, 5, 7)          # (nz, ny, nx)
DTYPES = {"f32": (torch.float32, None), "f64": (torch.float64, None),
          "bf16": (torch.bfloat16, None),
          "bf16-dot32": (torch.bfloat16, torch.float32)}
BRANCHES = ("plain", "conv_s", "restart", "zero_b")
_INT = {torch.float32: torch.int32, torch.float64: torch.int64,
        torch.bfloat16: torch.int16}


def _same(a, b):
    """Bit for bit, NaNs included."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in _INT:
        return torch.equal(a.view(_INT[a.dtype]), b.view(_INT[b.dtype]))
    return torch.equal(a, b)


def _leaves(v):
    return (v.A, v.U) if isinstance(v, State) else (v,)


def _map(fn, *trees):
    if isinstance(trees[0], State):
        return State(fn(*(t.A for t in trees)), fn(*(t.U for t in trees)))
    return fn(*trees)


def _state(gen, dtype, scale=1.0):
    nz, ny, nx = SHAPE
    f = lambda *s: (scale * torch.randn(*s, generator=gen,
                                        dtype=torch.float64)).to(dtype)
    return State(f(3, nz, ny, nx), f(nz, ny, nx))


def _op(v):
    """A fixed nonsymmetric, diagonally dominant linear operator."""
    return State(3.0 * v.A + torch.roll(v.A, 1, dims=-1)
                 - 0.5 * torch.roll(v.A, -1, dims=-2),
                 2.5 * v.U - 0.75 * torch.roll(v.U, 1, dims=0))


def _carry(branch, dtype, dot_dtype, seed):
    """A random carry (bs._Static) for one iteration that takes ``branch``."""
    gen = torch.Generator().manual_seed(seed)
    td = dot_dtype or dtype
    c = bs._Static()
    c.x, c.r, c.p = (_state(gen, dtype) for _ in range(3))
    # restart: r0 nearly orthogonal to everything, so |r.r0| / |b| < tol
    c.r0 = _state(gen, dtype, 1e-9 if branch == "restart" else 1.0)
    c.rr0 = bs.tree_dot(c.r, c.r0, dot_dtype)
    bnorm = {"zero_b": 0.0, "restart": 1.0}.get(branch, 17.0)
    c.bnorm = torch.tensor(bnorm, dtype=td)
    c.tol = {"conv_s": 1e6, "restart": 1e-3}.get(branch, 1e-6)
    c.relres = torch.tensor(float("inf"), dtype=td)
    c.done = torch.tensor(False)
    c.it = torch.tensor(3, dtype=torch.int32)
    return c


def _clone(c):
    d = bs._Static()
    for k, v in c.__dict__.items():
        d.__dict__[k] = (_map(torch.clone, v)
                         if isinstance(v, (State, torch.Tensor)) else v)
    return d


def _old_iterate(c, op, dots, on=None):
    """The iteration as solvers/bicgstab.py DeviceLoop._iterate wrote it
    (mv_dot None), frozen; returns its scalars."""
    def _put(dst, fn, *args, on=None):
        if on is None:
            fn(*args, out=dst)
        else:
            torch.where(on, fn(*args), dst, out=dst)

    tree_axpy = lambda a, x, y: _map(
        lambda xi, yi: yi + a.to(xi.dtype) * xi, x, y)
    ap = op(c.p)
    ap_r0, = dots([(ap, c.r0)])
    alpha = c.rr0 / ap_r0
    s = tree_axpy(-alpha, ap, c.r)
    ss, = dots([(s, s)])
    s_rel = torch.sqrt(ss) / c.bnorm
    conv_s = s_rel < c.tol
    as_ = op(s)
    as_s, as_as = dots([(as_, s), (as_, as_)])
    omega = as_s / as_as
    zero = torch.zeros_like(omega)
    omega_g = torch.where(conv_s, zero, omega)

    def x_new(xi, pi, si):
        t = xi + alpha.to(xi.dtype) * pi
        _put(xi, torch.add, t, omega_g.to(xi.dtype) * si, on=on)

    _map(x_new, c.x, c.p, s)
    neg = -omega_g
    _map(lambda ri, si, ai: _put(ri, torch.add, si, neg.to(ai.dtype) * ai,
                                 on=on), c.r, s, as_)
    rr, rr0_new = dots([(c.r, c.r), (c.r, c.r0)])
    r_rel = torch.sqrt(rr) / c.bnorm
    conv_r = r_rel < c.tol
    restart = (torch.abs(rr0_new) / c.bnorm) < c.tol
    beta = (alpha / omega) * rr0_new / c.rr0
    stop = restart | conv_s
    beta_g = torch.where(stop, torch.zeros_like(beta), beta)
    omega_p = torch.where(stop, zero, omega)

    def p_new(pi, ri, api):
        inner = pi - omega_p.to(ri.dtype) * api
        _put(pi, torch.add, ri, beta_g.to(ri.dtype) * inner, on=on)

    _map(p_new, c.p, c.r, ap)
    sel = restart if on is None else restart & on
    _map(lambda r0i, ri: torch.where(sel, ri, r0i, out=r0i), c.r0, c.r)
    _put(c.rr0, torch.where, restart, rr, rr0_new, on=on)
    _put(c.relres, torch.where, conv_s, s_rel, r_rel, on=on)
    _put(c.done, torch.bitwise_or, conv_s, conv_r, on=on)
    if on is None:
        c.it.add_(1)
    else:
        c.it.add_(on.to(torch.int32))
    return dict(alpha=alpha, ss=ss, s_rel=s_rel, omega=omega,
                omega_g=omega_g, rr=rr, rr0_new=rr0_new, r_rel=r_rel,
                beta=beta, beta_g=beta_g, omega_p=omega_p, conv_s=conv_s,
                conv_r=conv_r, restart=restart, s=s)


def _pieces(c, op, dots, on=None):
    """The same iteration on TorchGlue's three pieces, checked piece by
    piece: ``s`` leaves the carry as it was."""
    g = TorchGlue(dots)
    ap = op(c.p)
    ap_r0, = dots([(ap, c.r0)])
    before = _clone(c)
    w = g.s(c, ap, ap_r0)
    _assert_carry(c, before)
    as_ = op(w.s)
    as_s, as_as = dots([(as_, w.s), (as_, as_)])
    g.xr(c, w, as_, as_s, as_as, on)
    p0, r00 = _map(torch.clone, c.p), _map(torch.clone, c.r0)
    g.p(c, w, ap, on)
    return w, (p0, r00)


def _assert_carry(got, ref):
    for k in ("x", "r", "r0", "p"):
        for a, b in zip(_leaves(getattr(got, k)), _leaves(getattr(ref, k))):
            assert _same(a, b), k
    for k in ("rr0", "relres", "done", "it"):
        assert _same(getattr(got, k), getattr(ref, k)), k


def _dots(dot_dtype):
    return lambda pairs: [bs.tree_dot(a, b, dot_dtype) for a, b in pairs]


@pytest.mark.parametrize("on", [None, True, False], ids=["ungated", "on",
                                                          "off"])
@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_pieces_equal_the_iteration(dtype_name, branch, on):
    """s, xr and p in turn write the carry and form the scalars of the
    frozen iteration bit for bit, on every branch, gated or not."""
    dtype, dd = DTYPES[dtype_name]
    gate = None if on is None else torch.tensor(on)
    c = _carry(branch, dtype, dd, seed=7 + BRANCHES.index(branch))
    ref = _clone(c)
    old = _old_iterate(ref, _op, _dots(dd), gate)
    w, _ = _pieces(c, _op, _dots(dd), gate)
    _assert_carry(c, ref)
    for k in SCALARS + FLAGS:
        assert _same(getattr(w, k), old[k]), k
    for a, b in zip(_leaves(w.s), _leaves(old["s"])):
        assert _same(a, b)
    flag = {"conv_s": "conv_s", "restart": "restart"}.get(branch)
    if flag is not None:
        assert bool(old[flag])
    if branch == "plain":
        assert not (bool(old["conv_s"]) or bool(old["restart"]))
    if branch == "restart":
        assert not bool(old["conv_s"]) and not bool(old["conv_r"])
    if branch == "zero_b":
        assert not bool(old["conv_s"]) and not bool(old["restart"])


@pytest.mark.parametrize("branch", ("plain", "restart"))
def test_p_piece_alone(branch):
    """p: p = r + beta_g (p - omega_p ap), r0 := r on a restart only."""
    c = _carry(branch, torch.float32, None, seed=3)
    w, (_, r00) = _pieces(c, _op, _dots(None))
    if bool(w.restart):
        assert _same(c.r0.A, c.r.A) and _same(c.r0.U, c.r.U)
        assert float(w.beta_g) == 0.0 and float(w.omega_p) == 0.0
    else:
        assert _same(c.r0.A, r00.A) and _same(c.r0.U, r00.U)
        assert float(w.beta_g) == float(w.beta)


def _old_reference(apply_fn, b, x0, tol, itmax, dot_dtype=None,
                   mv_dot=None):
    """bicgstab_wr_reference as solvers/bicgstab.py wrote it before the
    glue's pieces, frozen (no ``reduce``)."""
    dt = lambda pairs: [bs.tree_dot(a, c, dot_dtype) for a, c in pairs]
    tree_axpy = lambda a, x, y: _map(
        lambda xi, yi: yi + a.to(xi.dtype) * xi, x, y)
    r = _map(torch.sub, b, apply_fn(x0))
    bb, rr0 = dt([(b, b), (r, r)])
    bnorm = torch.sqrt(bb)
    x, r0, p = x0, r, r
    relres = torch.full((), float("inf"), dtype=bnorm.dtype)
    done = bool(bnorm == 0.0)
    it = 0
    while not done and it <= itmax:
        it += 1
        if mv_dot is None:
            ap = apply_fn(p)
            ap_r0, = dt([(ap, r0)])
        else:
            ap, ap_r0, _ = mv_dot(p, r0)
        alpha = rr0 / ap_r0
        s = tree_axpy(-alpha, ap, r)
        ss, = dt([(s, s)])
        s_rel = torch.sqrt(ss) / bnorm
        conv_s = s_rel < tol
        if mv_dot is None:
            as_ = apply_fn(s)
            as_s, as_as = dt([(as_, s), (as_, as_)])
        else:
            as_, as_s, as_as = mv_dot(s, s)
        omega = as_s / as_as
        zero = torch.zeros_like(omega)
        omega_g = torch.where(conv_s, zero, omega)
        x = _map(lambda xi, pi, si: (xi + alpha.to(xi.dtype) * pi
                                     + omega_g.to(xi.dtype) * si), x, p, s)
        r_new = tree_axpy(-omega_g, as_, s)
        rr, rr0_new = dt([(r_new, r_new), (r_new, r0)])
        r_rel = torch.sqrt(rr) / bnorm
        conv_r = r_rel < tol
        restart = (torch.abs(rr0_new) / bnorm) < tol
        beta = (alpha / omega) * rr0_new / rr0
        stop = restart | conv_s
        beta_g = torch.where(stop, torch.zeros_like(beta), beta)
        omega_p = torch.where(stop, zero, omega)
        p = _map(lambda ri, pi, api: ri + beta_g.to(ri.dtype)
                 * (pi - omega_p.to(ri.dtype) * api), r_new, p, ap)
        r0 = _map(lambda ri, r0i: torch.where(restart, ri, r0i), r_new, r0)
        rr0 = torch.where(restart, rr, rr0_new)
        r = r_new
        relres = torch.where(conv_s, s_rel, r_rel)
        done = bool(conv_s | conv_r)
    return x, it, relres, done


@pytest.mark.parametrize("fused_dots", [False, True], ids=["op", "mv_dot"])
@pytest.mark.parametrize("tol", [1e-5, 0.3, "tensor"])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_reference_solve_equals_the_frozen_loop(dtype_name, tol, fused_dots):
    """The host loop on TorchGlue's pieces solves as the frozen loop did,
    bit for bit: x, relres, iterations, converged."""
    dtype, dd = DTYPES[dtype_name]
    if tol == "tensor":
        tol = torch.tensor(2e-3, dtype=dtype)
    gen = torch.Generator().manual_seed(11)
    b, x0 = _state(gen, dtype), _state(gen, dtype, 0.1)
    mv_dot = None
    if fused_dots:
        def mv_dot(v, w):
            y = _op(v)
            return y, bs.tree_dot(y, w, dd), bs.tree_dot(y, y, dd)
    x, it, relres, done = _old_reference(_op, b, x0, tol, 60, dd, mv_dot)
    res = bs.bicgstab_wr_reference(_op, b, x0, tol, 60, dd, mv_dot=mv_dot)
    assert (res.iterations, res.converged) == (it, done)
    assert it >= 1
    assert _same(res.relres, relres)
    for a, r in zip(_leaves(res.x), _leaves(x)):
        assert _same(a, r)


def test_reference_zero_rhs():
    """b = 0: no iteration, relres inf, x the warm start."""
    gen = torch.Generator().manual_seed(5)
    x0 = _state(gen, torch.float32)
    b = _map(torch.zeros_like, x0)
    res = bs.bicgstab_wr_reference(_op, b, x0, 1e-5, 10)
    assert res.iterations == 0 and res.converged and res.reads == 1
    assert torch.isinf(res.relres)
    assert _same(res.x.A, x0.A) and _same(res.x.U, x0.U)


class _Leaf:
    """A stand-in for a tensor on a device this host may not have: what
    glue_route reads of a leaf."""

    def __init__(self, dtype=torch.float32, device="cuda", contiguous=True,
                 numel=3 * 24 * 102 * 102):
        self.dtype, self.device = dtype, torch.device(device)
        self._contiguous, self._numel = contiguous, numel

    def is_contiguous(self):
        return self._contiguous

    def numel(self):
        return self._numel


def _stub(**kw):
    return State(_Leaf(**kw), _Leaf(**kw))


@pytest.mark.parametrize("case,kw,loop_kw", [
    ("cpu", {"device": "cpu"}, {}),
    ("bf16", {"dtype": torch.bfloat16}, {}),
    ("bf16-dot32", {"dtype": torch.bfloat16}, {"dot_dtype": torch.float32}),
    ("f64", {"dtype": torch.float64}, {}),
    ("dot64", {}, {"dot_dtype": torch.float64}),
    ("reduce", {}, {"reduce": lambda v: None}),
    ("batched", {}, {"batched": True}),
    ("strided", {"contiguous": False}, {}),
    ("huge", {"numel": 2 ** 31}, {}),
])
def test_route_torch(case, kw, loop_kw):
    """Every loop but the float32 one-card one keeps the torch glue."""
    loop = bs.DeviceLoop(_op, 10, **loop_kw)
    assert loop._route(_stub(**kw), _stub(**kw), 1e-3) == "torch"


@pytest.mark.parametrize("tol", [1e-3, "f32", "f64"])
def test_route_fused(tol):
    """A float32 loop on one card takes the kernels, with a float tol or a
    float32 one (a float64 tol would compare at float64: torch)."""
    loop = bs.DeviceLoop(_op, 10, mv_dot=lambda v, w: None)
    t = {"f32": torch.tensor(1e-3), "f64": torch.tensor(1e-3,
                                                        dtype=torch.float64)}
    want = "torch" if tol == "f64" else "fused"
    assert loop._route(_stub(), _stub(), t.get(tol, tol)) == want
    one = bs.DeviceLoop(_op, 10, dot_dtype=torch.float32)
    assert one._route(_stub(), _stub(), 1e-3) == "fused"
    assert glue_route(_stub(), _stub(), 1e-3) == "fused"


@pytest.mark.parametrize("dtype_name", ["f32", "f64", "bf16-dot32"])
def test_cpu_loop_reports_torch(dtype_name):
    """A solved CPU loop reports the torch glue and runs it."""
    dtype, dd = DTYPES[dtype_name]
    gen = torch.Generator().manual_seed(2)
    b, x0 = _state(gen, dtype), _state(gen, dtype, 0.1)
    loop = bs.DeviceLoop(_op, 40, dd)
    assert loop.glue is None
    res = loop.solve(b, x0, 1e-4)
    assert loop.glue == "torch" and isinstance(loop._glue, TorchGlue)
    ref = loop.reference(b, x0, 1e-4)
    assert res.iterations == ref.iterations and _same(res.relres, ref.relres)


def test_kernels_refuse_cpu_tensors():
    c = _carry("plain", torch.float32, None, seed=1)
    with pytest.raises(ValueError, match="cuda"):
        solver_glue.s(c, _op(c.p), torch.tensor(1.0))
