"""``ops/coupling_kernels.py`` on the CPU: the port's per-layer fused
coupling against the JAX package's ``ops.pallas_coupling.fused_coupling``
(its Pallas kernels in interpret mode) on the same numpy inputs and weights,
the RNVP / NICE layers and a train step under ``set_fused_kernels(True)`` in
both packages, the routing, and the CUDA source ``csrc/coupling_kernels.cu``
itself, compiled with the host compiler in its emulation mode
(``-DDF_HOST_EMULATION``), against the plain versions.

On the CPU the autograd Function runs the plain versions: the forward math
and ``coupling_bwd_plain``, the hand-written pullback the kernel implements
(not autograd), so the gradients below check that algebra.

Tolerance: 1e-5 absolute + relative where one coupling is compared (the same
f32 math at hidden <= 16, summed in another order); 1e-5 on the losses and
1e-4 on the parameters of three Adam steps (rounding fed through Adam).
"""

import ctypes
import os
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.models import layers as JL
from densityflows_tpu.ops.mlp import MLP as JaxMLP
from densityflows_tpu.ops.pallas_coupling import \
    fused_coupling as jax_fused_coupling
from densityflows_tpu_torch.models import fused_chain as TF
from densityflows_tpu_torch.models.fused_train import trainable_leaves
from densityflows_tpu_torch.ops import chain_kernels as ck
from densityflows_tpu_torch.ops import coupling_kernels as CK

from _torch_parity import assert_leaves_close, randomize, to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
ACTIVATIONS = ["relu", "tanh", "sigmoid", "silu", "gelu", "softplus", "elu",
               "leaky_relu", "identity"]


@pytest.fixture(autouse=True)
def _policy():
    yield
    JL.set_fused_kernels("auto")
    dt.set_fused_kernels("auto")


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32))


class Case:
    """One coupling's nets and inputs, as numpy, for both packages."""

    def __init__(self, kind="nvp", rows=37, K=4, A=3, hidden=16, n_s=2,
                 n_t=2, act="relu", bias=True, seed=0):
        rng = np.random.default_rng(seed)

        def net(n_sub):
            dims = [K] + [hidden] * n_sub + [A]
            ws = [(rng.normal(size=(a, b)) * (0.7 / np.sqrt(a))
                   ).astype(np.float32) for a, b in zip(dims[:-1], dims[1:])]
            bs = [(rng.normal(size=(b,)) * 0.1).astype(np.float32)
                  if bias else np.zeros((0,), np.float32) for b in dims[1:]]
            return ws, bs

        self.kind, self.act = kind, act
        self.s = net(n_s) if kind == "nvp" else None
        self.t = net(n_t)
        self.h = rng.normal(size=(rows, K)).astype(np.float32)
        self.y = rng.normal(size=(rows, A)).astype(np.float32)
        self.g_y = rng.normal(size=(rows, A)).astype(np.float32)
        self.g_ldj = rng.normal(size=(rows,)).astype(np.float32)

    def jax_nets(self):
        mk = lambda n: None if n is None else JaxMLP(  # noqa: E731
            tuple(jnp.asarray(w) for w in n[0]),
            tuple(jnp.asarray(b) for b in n[1]), self.act)
        return mk(self.s), mk(self.t)

    def torch_nets(self):
        mk = lambda n: None if n is None else dt.MLP(  # noqa: E731
            [_t(w) for w in n[0]], [_t(b) for b in n[1]], self.act)
        return mk(self.s), mk(self.t)

    def plain_nets(self):
        """``(weights, biases, activation)`` tuples for the wrappers."""
        def mk(n):
            if n is None:
                return None
            bs = [_t(b) for b in n[1]] if n[1][0].size else []
            return [_t(w) for w in n[0]], bs, self.act
        return mk(self.s), mk(self.t)


def _jax_run(case, direction, with_ldj):
    s, t = case.jax_nets()

    def f(h, y, s, t):
        return jax_fused_coupling(s, t, h, y, direction=direction,
                                  with_ldj=with_ldj)

    h, y = jnp.asarray(case.h), jnp.asarray(case.y)
    out, vjp = jax.vjp(f, h, y, s, t)
    cot = ((jnp.asarray(case.g_y), jnp.asarray(case.g_ldj)) if with_ldj
           else jnp.asarray(case.g_y))
    gh, gy, gs, gt = vjp(cot)
    grads = [gh, gy]
    for g in (gs, gt):
        if g is not None:
            grads += list(g.weights) + [b for b in g.biases if b.size]
    return (out if with_ldj else (out,)), grads


def _port_run(case, direction, with_ldj):
    s, t = case.torch_nets()
    h = _t(case.h).requires_grad_(True)
    y = _t(case.y).requires_grad_(True)
    out = CK.fused_coupling(s, t, h, y, direction=direction,
                            with_ldj=with_ldj)
    out = out if with_ldj else (out,)
    params = []
    for net in (s, t):
        if net is not None:
            params += list(net.weights) + [b for b in net.biases if b.numel()]
    cot = [_t(case.g_y)] + ([_t(case.g_ldj)] if with_ldj else [])
    grads = torch.autograd.grad(out, [h, y] + params, cot)
    return out, grads


def _assert_same_as_jax(case, direction, with_ldj):
    jout, jgrads = _jax_run(case, direction, with_ldj)
    tout, tgrads = _port_run(case, direction, with_ldj)
    assert len(jout) == len(tout) and len(jgrads) == len(tgrads)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    for i, (a, b) in enumerate(zip(tgrads, jgrads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=f"gradient {i}")


# -- the op against the Pallas kernels in interpret mode -------------------------

@pytest.mark.parametrize("with_ldj", [True, False])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("kind", ["nvp", "nice"])
def test_fused_coupling_equals_the_pallas_kernel(kind, direction, with_ldj):
    """Values, ldj and every gradient (a non-zero g_ldj) at 37 rows."""
    _assert_same_as_jax(Case(kind), direction, with_ldj)


@pytest.mark.parametrize("act", ACTIVATIONS)
def test_fused_coupling_activations_equal_the_pallas_kernel(act):
    _assert_same_as_jax(Case("nvp", act=act, seed=1), "inverse", True)


@pytest.mark.parametrize("what", ["no_bias", "n_s_ne_n_t", "one_dense_layer"])
def test_fused_coupling_shapes_equal_the_pallas_kernel(what):
    kw = {"no_bias": dict(bias=False), "n_s_ne_n_t": dict(n_s=1, n_t=3),
          "one_dense_layer": dict(n_s=0, n_t=0, rows=9)}[what]
    _assert_same_as_jax(Case("nvp", act="tanh", seed=2, **kw), "forward",
                        True)


def test_plain_pullback_is_not_autograd_but_agrees_with_it():
    """``coupling_bwd_plain`` against autograd of ``coupling_fwd_plain``'s
    math on float64 copies: the hand-written algebra, not the same graph."""
    case = Case("nvp", act="gelu", seed=3)
    s, t = case.plain_nets()
    h, y = _t(case.h), _t(case.y)
    for direction in ("forward", "inverse"):
        dh, dy, gs, gt = CK.coupling_bwd_plain(
            s, t, h, y, _t(case.g_y), _t(case.g_ldj), direction=direction)
        leaves = [h, y] + s[0] + s[1] + t[0] + t[1]
        leaves = [x.double().requires_grad_(True) for x in leaves]
        it = iter(leaves[2:])
        s64 = ([next(it) for _ in s[0]], [next(it) for _ in s[1]], s[2])
        t64 = ([next(it) for _ in t[0]], [next(it) for _ in t[1]], t[2])
        with torch.enable_grad():
            out, ldj = _plain_math(s64, t64, leaves[0], leaves[1], direction)
            want = torch.autograd.grad(
                [out, ldj], leaves, [_t(case.g_y).double(),
                                     _t(case.g_ldj).double()])
        got = [dh, dy] + gs[0] + gs[1] + gt[0] + gt[1]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def _plain_math(s, t, h, y, direction):
    def mlp(x, net):
        ws, bs, act = net
        for i, w in enumerate(ws):
            x = x @ w + bs[i]
            if i < len(ws) - 1:
                x = CK._act(act, x)
        return x

    sv, tv = mlp(h, s), mlp(h, t)
    if direction == "forward":
        return y * torch.exp(sv) + tv, sv.sum(-1)
    return (y - tv) * torch.exp(-sv), -sv.sum(-1)


# -- the layers and the train step in both packages ---------------------------------

def _jax_layer(kind, seed, **kw):
    layer = df.coupling_layer(5, [0, 1, 2], n=1, kind=kind,
                              key=jax.random.key(seed), hidden_dim_s=8,
                              hidden_dim_t=8, **kw)
    return randomize(layer, seed + 10)


@pytest.mark.parametrize("kind", ["RNVPCouplingLayer", "NICECouplingLayer"])
def test_layers_under_true_equal_the_jax_layers(kind):
    """forward / inverse / forward_ and the gradients of a loss through
    ``inverse`` with both packages routed to their per-layer kernels."""
    jlayer = _jax_layer(getattr(df, kind), 4, activation_s="silu",
                        activation_t="silu")
    tlayer = to_torch(jlayer)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 7, 5)).astype(np.float32)   # two batch dims
    th = rng.uniform(size=(3, 7, 1)).astype(np.float32)
    JL.set_fused_kernels(True)
    dt.set_fused_kernels(True)
    for fn in ("forward", "inverse"):
        a = getattr(jlayer, fn)(jnp.asarray(x), jnp.asarray(th))
        b = getattr(tlayer, fn)(_t(x), _t(th))
        for u, v in zip(b, a):
            np.testing.assert_allclose(u.detach().numpy(), np.asarray(v),
                                       **TOL)
    np.testing.assert_allclose(
        tlayer.forward_(_t(x), _t(th)).detach().numpy(),
        np.asarray(jlayer.forward_(jnp.asarray(x), jnp.asarray(th))), **TOL)

    def jloss(layer):
        z, ldj = layer.inverse(jnp.asarray(x), jnp.asarray(th))
        return jnp.sum(jnp.sin(z)) - 0.5 * jnp.sum(ldj)

    jg = jax.grad(jloss)(jlayer)
    z, ldj = tlayer.inverse(_t(x), _t(th))
    (torch.sin(z).sum() - 0.5 * ldj.sum()).backward()
    assert_leaves_close(jg, _grads_module(tlayer), 1e-5)


def _grads_module(layer):
    """A copy of the layer whose parameters hold the gradients."""
    import copy

    g = copy.deepcopy(layer)
    with torch.no_grad():
        for p, q in zip(g.parameters(), layer.parameters()):
            p.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
    return g


def test_three_train_steps_under_true_equal_jax():
    """make_train_step on a d 5 / n 1 / hidden 8 chain of three couplings
    (one NICE) and a normalization layer, both packages under
    set_fused_kernels(True), the same batches: losses 1e-5, parameters
    1e-4."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(64, 5)).astype(np.float32)
    ks = jax.random.split(jax.random.key(7), 3)
    h = dict(n=1, hidden_dim_s=8, hidden_dim_t=8)
    chain = randomize(df.flow_chain(
        df.coupling_layer(5, [0, 1, 2], key=ks[0], **h),
        df.coupling_layer(5, [2, 3, 4], key=ks[1], kind=df.NICECouplingLayer,
                          **h),
        df.coupling_layer(5, [4, 0, 1], key=ks[2], activation_s="tanh",
                          activation_t="tanh", **h),
        df.normalization_layer(x, -1.0, 1.0)), 8)
    tchain = to_torch(chain)
    batches = [(rng.normal(size=(24, 5)).astype(np.float32),
                rng.uniform(size=(24, 1)).astype(np.float32),
                (np.arange(24) < 20 - 3 * k).astype(np.float32))
               for k in range(3)]
    JL.set_fused_kernels(True)
    dt.set_fused_kernels(True)
    tx = optax.adam(1e-3)
    jstep = df.make_train_step(tx)
    jmodel = jax.tree_util.tree_map(jnp.array, chain)
    jstate = tx.init(jmodel)
    opt = dt.adam(1e-3)
    tstep = dt.make_train_step(opt)
    tstate = opt.init(trainable_leaves(tchain))
    for xb, thb, mb in batches:
        jmodel, jstate, jloss = jstep(jmodel, jstate, df.StandardNormal(5),
                                      jnp.asarray(xb), jnp.asarray(thb),
                                      jnp.asarray(mb))
        tchain, tstate, tloss = tstep(tchain, tstate, dt.StandardNormal(5),
                                      _t(xb), _t(thb), _t(mb))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=0,
                                   atol=1e-5)
    assert_leaves_close(jmodel, tchain, 1e-4)


# -- routing ----------------------------------------------------------------------

@pytest.fixture
def calls(monkeypatch):
    """Counts the calls of the per-layer route (``fused_coupling``)."""
    seen = []
    real = CK.fused_coupling

    def counting(*a, **kw):
        seen.append(kw.get("direction"))
        return real(*a, **kw)

    monkeypatch.setattr(CK, "fused_coupling", counting)
    return seen


def _torch_layer(**kw):
    g = torch.Generator().manual_seed(0)
    return dt.coupling_layer(5, [0, 1, 2], n=1, generator=g, device="cpu",
                             hidden_dim_s=8, hidden_dim_t=8,
                             zero_init_final=False, **kw)


def _xth(rows=6):
    rng = np.random.default_rng(0)
    return (_t(rng.normal(size=(rows, 5))), _t(rng.uniform(size=(rows, 1))))


@pytest.mark.parametrize("mode", ["auto", False, True])
def test_only_true_takes_the_per_layer_route(calls, mode):
    x, th = _xth()
    dt.set_fused_kernels(mode)
    for kind in (dt.RNVPCouplingLayer, dt.NICECouplingLayer):
        layer = _torch_layer(kind=kind)
        layer.forward(x, th)
        layer.inverse(x, th)
        layer.forward_(x, th)
    assert calls == (["forward", "inverse", "forward"] * 2 if mode is True
                     else [])


def test_clamped_and_joint_layers_have_no_per_layer_route(calls):
    x, th = _xth()
    dt.set_fused_kernels(True)
    for layer in (_torch_layer(max_log_scale=2.0),
                  _torch_layer(joint_conditioner=True)):
        z, ldj = layer.inverse(x, th)
        layer.forward(z, th)
        layer.forward_(z, th)
    assert calls == []
    assert not hasattr(dt.JointRNVPCouplingLayer, "_fused")


def test_float64_raises_type_error_naming_the_switch():
    layer = _torch_layer().double()
    x, th = _xth()
    dt.set_fused_kernels(True)
    with pytest.raises(TypeError, match=r"set_fused_kernels\(False\)"):
        layer.inverse(x.double(), th.double())
    dt.set_fused_kernels(False)
    z, _ = layer.inverse(x.double(), th.double())
    assert z.dtype == torch.float64


def test_fold_layers_under_true_launches_nothing_and_equals_false(calls):
    chain = dt.flow_chain(
        _torch_layer(), _torch_layer(kind=dt.NICECouplingLayer, reverse=True),
        _torch_layer(joint_conditioner=True))
    x, th = _xth(9)
    out = {}
    for mode in (False, True):
        dt.set_fused_kernels(mode)
        out[mode] = [TF.fold_layers(chain, x, th, "inv", True),
                     TF.fold_layers(chain, x, th, "fwd", True),
                     (TF.fold_layers(chain, x, th, "fwd", False),)]
    assert calls == []
    for a, b in zip(out[True], out[False]):
        for u, v in zip(a, b):
            assert torch.equal(u, v)


def test_input_checks():
    case = Case("nvp", rows=5)
    s, t = case.plain_nets()
    h, y = _t(case.h), _t(case.y)
    with pytest.raises(ValueError, match="direction"):
        CK.coupling_fwd(s, t, h, y, direction="sideways")
    with pytest.raises(ValueError, match="contiguous"):
        CK.coupling_fwd(s, t, h.T.contiguous().T, y, direction="forward")
    with pytest.raises(ValueError, match="needs"):
        CK.coupling_fwd(s, t, h[:, :3].contiguous(), y, direction="forward")
    with pytest.raises(TypeError, match="float32 only"):
        CK.coupling_fwd(s, t, h.double(), y, direction="forward")
    with pytest.raises(ValueError, match="unsupported activation"):
        CK.coupling_fwd(None, (t[0], t[1], "swish"), h, y,
                        direction="forward")
    with pytest.raises(ValueError, match="tile rows"):
        CK.set_tile_rows(12)
    # a net whose one row does not fit a block's shared memory raises
    wide = ([torch.zeros(4, 70000), torch.zeros(70000, 3)], [], "relu")
    with pytest.raises(ValueError, match="too wide"):
        CK.pick_tile("fwd", lambda tb: CK.fwd_shared_bytes(tb, None, wide,
                                                           4, 3))
    # hidden 1024 runs the forward: a tile set too wide for it is halved
    # until it fits
    h1024 = ([torch.zeros(24, 1024), torch.zeros(1024, 1024),
              torch.zeros(1024, 16)], [], "relu")
    CK.set_tile_rows(32)
    try:
        assert CK.pick_tile("fwd", lambda tb: CK.fwd_shared_bytes(
            tb, h1024, h1024, 24, 16)) == 16
    finally:
        CK.set_tile_rows(None)
    # the backward has no tile: products over all rows, dW in row segments;
    # its workspace holds U, act(U) and the output per row, then the
    # segments' dW / db partials
    h512 = ([torch.zeros(24, 512), torch.zeros(512, 512),
             torch.zeros(512, 16)], [torch.zeros(512), torch.zeros(512),
                                     torch.zeros(16)], "relu")
    assert CK.bwd_segments(8192) == 16 and CK.bwd_segments(100) == 1
    assert CK.bwd_segments(1 << 20) == 32
    one = ([torch.zeros(24, 16)], [], "relu")
    assert CK.bwd_launches(h512, h512) == 7 and CK.bwd_launches(None, one) == 3
    assert CK.bwd_launches(one, h512) == 7
    per_row = 2 * (2 * 512) + 16
    items = 25 * 512 + 513 * 512 + 513 * 16
    assert CK.grad_items(h512, h512) == 2 * items
    assert CK.workspace_floats(64, h512, h512, 3) == \
        64 * 2 * per_row + 3 * 2 * items
    assert CK.launch_counts() == {"coupling_fwd": 0, "coupling_bwd": 0,
                                  "coupling_bwd_reduce": 0}


# -- the CUDA source under host emulation -------------------------------------------

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/coupling_kernels.cu`` compiled as plain C++ (its
    DF_HOST_EMULATION mode with tests/cuda_host_emulation.h): ``fwd(threads,
    reverse)`` / ``bwd(reverse)`` give launchers for the wrappers'
    ``_run_fwd`` / ``_run_bwd``. ``reverse`` bit 0: the threads of a phase
    last first; bit 1: the tiles and product blocks (and the elementwise
    kernels' items) last first. Every tile and product block starts from a
    NaN-filled shared array; a product block runs its 256 threads."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = str(tmp_path_factory.mktemp("emu") / "libcoupling_emulated.so")
    src = os.path.join(ROOT, "densityflows_tpu_torch", "csrc",
                       "coupling_kernels.cu")
    # -ffp-contract=off: fmaf() stays the only fused multiply-add, as written
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-x", "c++", "-DDF_HOST_EMULATION", "-include",
         os.path.join(ROOT, "tests", "cuda_host_emulation.h"), "-o", out,
         src], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(out)
    P, I = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
    i = ctypes.c_int
    lib.df_coupling_fwd_emulated.argtypes = [P, I, i, i, i]
    lib.df_coupling_bwd_emulated.argtypes = [P, I, ctypes.c_longlong, i, i]
    ll = ctypes.c_longlong
    lib.df_coupling_tile_emulated.argtypes = [P, I, I, i, ll, ll, i]

    class Launch:
        @staticmethod
        def fwd(threads, reverse):
            return lambda p, ia, _nt, shared: lib.df_coupling_fwd_emulated(
                p, ia, threads, shared, reverse)

        @staticmethod
        def bwd(reverse):
            return lambda p, ia, ws_floats, segs: \
                lib.df_coupling_bwd_emulated(p, ia, ws_floats, segs, reverse)

        @staticmethod
        def tile(reverse):
            """The tensor-core forward's weight tiling; a launcher for
            ``_run_fwd_tc`` that runs it and no fold."""
            return lambda p, ia, lay, n_l, bias, tiled, *_rest: \
                lib.df_coupling_tile_emulated(p, ia, lay, n_l, bias, tiled,
                                              reverse)

    return Launch


def _flat(out):
    """Every tensor of a wrapper's result, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    flat = []
    for o in out:
        flat += [] if o is None else _flat(o)
    return flat


def _emulate(emulated, case, direction, threads=64, reverse=0, tile=None,
             with_ldj=True, segs=None):
    s, t = case.plain_nets()
    h, y = _t(case.h), _t(case.y)
    fwd = CK._run_fwd(emulated.fwd(threads, reverse), s, t, h, y,
                      direction=direction, with_ldj=with_ldj, tile=tile)
    bwd = CK._run_bwd(emulated.bwd(reverse), s, t, h, y, _t(case.g_y),
                      _t(case.g_ldj), direction=direction, segs=segs)
    return _flat(fwd), _flat(bwd)


def _close(a, b):
    """1e-5 relative, and 1e-5 absolute scaled by 1 + the largest entry of
    the reference: a dW / db sums up to 1001 rows in another order."""
    scale = 1.0 + float(b.abs().max()) if b.numel() else 1.0
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * scale)


def _plain(case, direction, with_ldj=True):
    s, t = case.plain_nets()
    h, y = _t(case.h), _t(case.y)
    fwd = CK.coupling_fwd_plain(s, t, h, y, direction=direction,
                                with_ldj=with_ldj)
    bwd = CK.coupling_bwd_plain(s, t, h, y, _t(case.g_y), _t(case.g_ldj),
                                direction=direction)
    return _flat(fwd), _flat(bwd)


EMU_CASES = {
    "nvp": dict(kind="nvp"),
    "nice": dict(kind="nice"),
    "ragged_1001": dict(kind="nvp", rows=1001, hidden=8, act="tanh"),
    "below_one_tile": dict(kind="nvp", rows=5, act="sigmoid"),
    "d7_n3_h18": dict(kind="nvp", K=3 + 3, A=4, hidden=18, act="gelu"),
    "n_s1_n_t3": dict(kind="nvp", n_s=1, n_t=3, act="silu"),
    "one_dense_layer": dict(kind="nvp", n_s=0, n_t=0),
    "no_bias": dict(kind="nice", bias=False, act="elu"),
}


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("case_name", sorted(EMU_CASES))
def test_cuda_source_emulated_equals_plain_versions(emulated, case_name,
                                                    direction):
    """y, ldj, dh, dy and every dW / db of the CUDA source against the plain
    versions (``_close``)."""
    case = Case(seed=11, **EMU_CASES[case_name])
    got_f, got_b = _emulate(emulated, case, direction)
    want_f, want_b = _plain(case, direction)
    assert len(got_f) == len(want_f) and len(got_b) == len(want_b)
    for a, b in zip(got_f + got_b, want_f + want_b):
        _close(a, b)
    got = _flat(CK._run_fwd(emulated.fwd(64, 0), *case.plain_nets(),
                            _t(case.h), _t(case.y), direction=direction,
                            with_ldj=False))
    _close(got[0], want_f[0])


@pytest.mark.parametrize("act", ACTIVATIONS)
def test_cuda_source_emulated_activations(emulated, act):
    case = Case("nvp", rows=21, act=act, seed=12)
    got_f, got_b = _emulate(emulated, case, "inverse", tile=8)
    want_f, want_b = _plain(case, "inverse")
    for a, b in zip(got_f + got_b, want_f + want_b):
        _close(a, b)


def test_cuda_source_emulated_is_independent_of_thread_and_tile_order(
        emulated):
    """Threads and tiles in either order, another thread count, a NaN-filled
    shared array per tile: the same bits; another tile size agrees to
    rounding (the reduction sums all rows in row order whatever the tile)."""
    case = Case("nvp", rows=45, hidden=12, act="softplus", seed=13)
    runs = [_emulate(emulated, case, "forward", nt, rev, tile=8)
            for nt, rev in ((64, 0), (64, 1), (64, 2), (32, 3), (256, 0))]
    for other in runs[1:]:
        for a, b in zip(other[0] + other[1], runs[0][0] + runs[0][1]):
            assert torch.equal(a, b)
    for tile in (1, 4, 64):
        got = _emulate(emulated, case, "forward", 64, 3, tile=tile)
        for a, b in zip(got[0] + got[1], runs[0][0] + runs[0][1]):
            _close(a, b)
    for tile in (1, 64):   # dW / db: the same rows in the same order
        got = _emulate(emulated, case, "forward", 64, 0, tile=tile)
        for a, b in zip(got[1][2:], runs[0][1][2:]):
            assert torch.equal(a, b)


def test_cuda_source_emulated_nan_row(emulated):
    """A NaN in one input row: the kernel's NaN pattern is the plain
    version's (relu keeps the NaN; its derivative at NaN is 0)."""
    case = Case("nvp", rows=19, seed=14)
    case.h[3, 1] = np.nan
    got_f, got_b = _emulate(emulated, case, "inverse", tile=8)
    want_f, want_b = _plain(case, "inverse")
    for a, b in zip(got_f + got_b, want_f + want_b):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        ok = ~torch.isnan(b)
        _close(a[ok], b[ok])
    assert bool(torch.isnan(got_f[0][3]).all())
    assert not bool(torch.isnan(got_f[0][4]).any())


@pytest.mark.parametrize("kind", ["nvp", "nice"])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_cuda_source_emulated_products_segments_and_odd_widths(
        emulated, kind, direction):
    """The backward's products at widths that are no multiple of the
    register tile (K 7, hidden 37, A 5), a ragged row count (1001 rows: no
    multiple of any tile or segment), relu with a NaN row, two nets of other
    depths: against the plain version at 1, 3 and 7 row segments of the dW
    products (1e-5, ``_close``; the segment counts agree to rounding), the
    same bits with the product blocks and the elementwise items in either
    order, and the plain version's NaN pattern."""
    case = Case(kind, rows=1001, K=7, A=5, hidden=37, n_s=1, n_t=2,
                act="relu", seed=15)
    case.h[3, 2] = np.nan
    want_f, want_b = _plain(case, direction)
    runs = {}
    for segs in (1, 3, 7):
        _, got_b = _emulate(emulated, case, direction, segs=segs)
        for a, b in zip(got_b, want_b):
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            ok = ~torch.isnan(b)
            _close(a[ok], b[ok])
        runs[segs] = got_b
    _, again = _emulate(emulated, case, direction, reverse=3, segs=3)
    for a, b in zip(again, runs[3]):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(a[~torch.isnan(a)], b[~torch.isnan(b)])
    # dh and dy do not depend on the segments; dW / db differ by rounding
    for a, b in zip(runs[7], runs[1]):
        ok = ~torch.isnan(b)
        _close(a[ok], b[ok])
    # the NaN reaches dh through ds (RealNVP), and dW_0 through h itself
    assert bool(torch.isnan(runs[1][0][3]).all()) == (kind == "nvp")
    assert not bool(torch.isnan(runs[1][0][4]).any())
    assert bool(torch.isnan(runs[1][2]).any())


def test_cuda_source_refuses_too_little_shared_memory(emulated):
    case = Case("nvp", rows=8)
    s, t = case.plain_nets()
    short = lambda p, ia, nt, shared: emulated.fwd(64, 0)(  # noqa: E731
        p, ia, nt, shared - 4)
    with pytest.raises(RuntimeError, match="coupling_fwd launch failed"):
        CK._run_fwd(short, s, t, _t(case.h), _t(case.y),
                    direction="forward", with_ldj=True)


# -- coupling_fwd's tensor-core path ------------------------------------------
#
# The card's forward runs a coupling as a one-coupling program of the chain
# kernels' format (CK.tc_plan) on wgmma in 3xTF32, after a launch that tiles
# both nets' weights (csrc/coupling_kernels.cu::coupling_tile_kernel). The
# products have no CPU emulation (inline PTX); what the CPU checks: the
# tiling, emulated, against ops/chain_kernels.py::tile_weights; the lowered
# program, executed by packed_apply_reference, against the Pallas kernel in
# interpret mode; a model of the 3xTF32 arithmetic against the gate.

def _main_case(rows=256, seed=3):
    """The opt-in train step's shapes (K 24, A 16, hidden 256, three dense
    layers a net), glorot-scaled weights."""
    return Case(kind="nvp", rows=rows, K=24, A=16, hidden=256, n_s=2, n_t=2,
                seed=seed)


# the tensor-core path's cases: the emulated ones, the main shape, and
# hidden widths that take the tiling's other code (128-column chunks at
# 100; passes of 256 columns then a 128- or a 32-column chunk at 300 and
# 520) at the fold's smaller row tiles
TC_CASES = dict(
    EMU_CASES, main=None,
    hidden_100=dict(kind="nvp", rows=70, K=9, A=5, hidden=100, act="tanh"),
    hidden_300=dict(kind="nvp", K=6, A=4, hidden=300, n_s=1, act="silu"),
    hidden_520=dict(kind="nice", K=5, A=3, hidden=520, n_t=1, act="gelu"))
# the fold's row tile at each (64 where the tile fits a block)
TC_TILE_ROWS = dict(dict.fromkeys(TC_CASES, 64), hidden_300=32,
                    hidden_520=16)


def _tc_case(name):
    return _main_case() if name == "main" else Case(**TC_CASES[name])


@pytest.mark.parametrize("case_name", sorted(TC_CASES))
def test_tc_weight_tiling_emulated_equals_tile_weights(emulated, case_name):
    """The tiling kernel's workspace, in either order of its floats: the
    biases zero-padded to 4 where the program reads them, then every dense
    layer's chunks exactly as ``tile_weights`` lays out the padded matrices
    (the bulk copies' layout), bit for bit."""
    case = _tc_case(case_name)
    s, t = case.plain_nets()
    h, y = _t(case.h), _t(case.y)
    K, A = h.shape[1], y.shape[1]
    plan = CK.tc_plan(s, t, K, A, "inverse")
    assert plan is not None and plan.bias_floats % 4 == 0
    model = CK.tc_model(plan, s, t, K, A)
    tcl = CK._TcLaunch(plan, torch.tensor(plan.prog, dtype=torch.int32),
                       (ctypes.c_int * (4 * len(plan.layout)))(
                           *[v for lay in plan.layout for v in lay]),
                       CK._iargs(s, t, "inverse", True, h.shape[0], K, A, 0))
    for reverse in (0, 1):
        ws = []

        def launch(p, ia, lay, n_l, bias, tiled, *rest):
            buf = torch.full((bias + tiled,), float("nan"))
            # the workspace is ptrs[8]
            p[8] = buf.data_ptr()
            ws.append(buf)
            return emulated.tile(reverse)(p, ia, lay, n_l, bias, tiled)

        CK._run_fwd_tc(launch, tcl, s, t, h, y, with_ldj=True)
        got = ws[0]
        assert torch.equal(got[:plan.bias_floats],
                           model.flat[:plan.bias_floats])
        assert torch.equal(got[plan.bias_floats:], model.tiled)


@pytest.mark.parametrize("with_ldj", [True, False])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("case_name", sorted(TC_CASES))
def test_tc_lowering_equals_the_pallas_kernel(case_name, direction, with_ldj):
    """The one-coupling program, executed instruction by instruction on the
    padded buffers (``packed_apply_reference``), against the JAX package's
    Pallas forward in interpret mode: 1e-5 (the main shape: 1e-5 relative,
    1e-4 absolute, sums of 256 products in another order)."""
    case = _tc_case(case_name)
    s, t = case.plain_nets()
    h, y = _t(case.h), _t(case.y)
    K, A = h.shape[1], y.shape[1]
    model = CK.tc_model(CK.tc_plan(s, t, K, A, direction), s, t, K, A)
    got = ck.packed_apply_reference(model, y, h, with_ldj=with_ldj)
    got = got if with_ldj else (got,)
    want, _ = _jax_run(case, direction, with_ldj)
    tol = TOL if case_name != "main" else dict(rtol=1e-5, atol=1e-4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


def _gate_ratio(got, want, rtol=1e-4, atol=1e-4):
    """max |got - want| / (atol + rtol |want|): at most 1 passes
    chip_smoke.py's coupling gate (KERNEL_TOL)."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


@pytest.mark.parametrize("case_name", ["main", "d7_n3_h18", "n_s1_n_t3",
                                       "one_dense_layer", "ragged_1001",
                                       "hidden_100", "hidden_300",
                                       "hidden_520"])
def test_tc_3xtf32_model_stays_inside_the_gate(case_name):
    """The program with every product in modelled 3xTF32 (the chain kernels'
    split, tests/test_torch_chain_kernels.py's model) against the plain f32
    version, inverse with ldj: at most a tenth of the 1e-4 gate, at the main
    path's widths and at the odd small ones."""
    from test_torch_chain_kernels import _matmul_3xtf32

    case = _tc_case(case_name)
    s, t = case.plain_nets()
    h, y = _t(case.h), _t(case.y)
    K, A = h.shape[1], y.shape[1]
    model = CK.tc_model(CK.tc_plan(s, t, K, A, "inverse"), s, t, K, A)
    got = ck.packed_apply_reference(model, y, h, with_ldj=True,
                                    matmul=_matmul_3xtf32)
    want = CK.coupling_fwd_plain(s, t, h, y, direction="inverse",
                                 with_ldj=True)
    for a, b in zip(got, want):
        assert _gate_ratio(a, b) < 0.1


def test_tc_path_envelope_and_decline():
    """Every shape of the tensor-core cases takes the tensor cores at its
    row tile (64, else the first of 32 / 16 that fits); a hidden layer too
    wide for the fold's tile at 16 rows keeps the FMA body, with the
    reason. On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    for name in TC_CASES:
        case = _tc_case(name)
        s, t = case.plain_nets()
        K, A = case.h.shape[1], case.y.shape[1]
        plan = CK.tc_plan(s, t, K, A, "forward")
        assert plan is not None, name
        assert plan.tile_rows == TC_TILE_ROWS[name], name
        assert CK.tc_reason(s, t, K, A) is None
    wide = Case(kind="nvp", rows=8, K=4, A=3, hidden=3000)
    s, t = wide.plain_nets()
    assert CK.tc_plan(s, t, 4, 3, "forward") is None
    assert "does not fit" in CK.tc_reason(s, t, 4, 3)
    with pytest.raises(ValueError):
        CK.set_tile_rows(12)
    CK.reset_launch_counts()
    case = _main_case(rows=16)
    s, t = case.plain_nets()
    got = CK.coupling_fwd(s, t, _t(case.h), _t(case.y), direction="forward")
    want = CK.coupling_fwd_plain(s, t, _t(case.h), _t(case.y),
                                 direction="forward", with_ldj=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert CK.launch_counts() == dict.fromkeys(CK.launch_counts(), 0)
    assert CK.coupling_fwd.tc_launches == CK.coupling_fwd.tile_launches == 0


def test_coupling_kernel_source_is_hand_written():
    csrc = os.path.join(ROOT, "densityflows_tpu_torch", "csrc")
    with open(os.path.join(csrc, "coupling_kernels.cu")) as f:
        text = f.read()
    for symbol in ("df_coupling_fwd", "df_coupling_bwd", "df_coupling_fwd_tc",
                   "coupling_fwd_kernel", "coupling_fwd_tc_kernel",
                   "coupling_tile_kernel", "coupling_product_kernel",
                   "coupling_pullback_kernel", "coupling_bwd_reduce_kernel",
                   "tile_product", "df_cp_async4", "__global__", "dact_fn",
                   "u < 0.f ? 0.f : u", "expm1f", "log1pf",
                   "cudaFuncAttributeMaxDynamicSharedMemorySize"):
        assert symbol in text
    # the backward and the FMA forward stay f32 FMA in this file's own
    # loops; the tensor-core forward is the chain kernels' fold, shared
    # through wgmma_fold.cuh (the card's build only)
    for banned in ("atomicadd", "cublas", "cudnn", "cutlass",
                   "torch/extension.h", "mma.sync", "wgmma.mma_async"):
        assert banned not in text.lower()
    assert re.findall(r'#include "([^"]+)"', text) == [
        "async_copy.cuh", "wgmma_fold.cuh"]
    with open(os.path.join(csrc, "wgmma_fold.cuh")) as f:
        fold = f.read()
    for symbol in ("wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32",
                   "cvt.rna.tf32.f32", "apply_tile", "namespace wgf"):
        assert symbol in fold
