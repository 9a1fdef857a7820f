"""The port's config builders (``utils/config.py``) and toy data sets
(``utils/datasets.py``) against the JAX package on the CPU: ``build_flow``
gives the JAX package's ``element_spec`` for every family and tail,
``run_experiment`` trains from a config and hands its precision and
memory options to ``train``, and the data sets equal JAX's bit for bit.
"""

import sys

import jax
import numpy as np
import pytest
import torch

import densityflows_tpu as df
import densityflows_tpu_torch as dt
from densityflows_tpu.utils import datasets as jds
from densityflows_tpu.utils.checkpoint import element_spec as jax_spec
from densityflows_tpu_torch.utils import datasets as tds
from densityflows_tpu_torch.utils.checkpoint import element_spec

from _torch_parity import TOL


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(90, 4)).astype(np.float32)
    th = rng.uniform(size=(90, 2)).astype(np.float32)
    return df.DataArrays.make(x, th, rng=0), dt.DataArrays.make(x, th, rng=0)


def _configs(module, family, tail, mix):
    net = module.NetConfig(hidden_dim_s=6, hidden_dim_t=8, n_sublayers_t=3,
                           activation_s="tanh", max_log_scale=1.5)
    return module.FlowConfig(net=net, n_blocks=2, family=family, tail=tail,
                             mix=mix, n_bins=3, norm_alpha=-2.0)


@pytest.mark.parametrize("tail", ["normalization", "actnorm", "logit",
                                  "none"])
@pytest.mark.parametrize("family", ["rnvp", "nice", "rqs", "maf"])
def test_build_flow_spec_equals_jax(data, family, tail):
    jd, td = data
    mix = "permute" if family == "rnvp" else "none"
    jflow = df.build_flow(_configs(df, family, tail, mix), jd)
    tflow = dt.build_flow(_configs(dt, family, tail, mix), td,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    assert element_spec(tflow.model) == jax_spec(jflow.model)
    assert tflow.device.type == "cpu" and tflow.metadata.n == 2
    # the data-dependent tails hold the JAX package's values
    if tail != "none":
        for a, b in zip(tflow.model.layers[-1].buffers() if tail != "actnorm"
                        else tflow.model.layers[-1].parameters(),
                        jax.tree_util.tree_leaves(jflow.model.layers[-1])):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       **TOL)


def test_build_flow_linear_mix_and_errors(data):
    jd, td = data
    cfg = dt.FlowConfig(n_blocks=3, mix="linear")
    flow = dt.build_flow(cfg, td, device="cpu")
    kinds = [type(layer).__name__ for layer in flow.model.layers]
    assert kinds == ["CouplingBlock", "InvertibleLinearLayer",
                     "CouplingBlock", "InvertibleLinearLayer",
                     "CouplingBlock", "NormalizationLayer"]
    assert kinds == [type(layer).__name__ for layer in
                     df.build_flow(df.FlowConfig(n_blocks=3, mix="linear"),
                                   jd).model.layers]
    for bad, match in ((dict(family="glow"), "family"),
                       (dict(mix="shuffle"), "mix"),
                       (dict(tail="clip"), "tail")):
        with pytest.raises(ValueError, match=match):
            dt.build_flow(dt.FlowConfig(**bad), td, device="cpu")


def test_run_experiment(data):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(150, 3)).astype(np.float32)
    th = rng.uniform(size=(150, 1)).astype(np.float32)
    cfg = dt.FlowConfig(train=dt.TrainConfig(epochs=2, batchsize=32,
                                             verbose=False),
                        family="rqs", n_blocks=1)
    flow, dset, state = dt.run_experiment(
        cfg, x, th, generator=torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(flow.model.layers[0].layer_1, dt.RQSCouplingLayer)
    assert len(flow.train_loss) == 2 and np.isfinite(flow.valid_loss).all()
    assert state.count == 2 * -(-len(dset.partition.training) // 32)
    jflow, jdata, _ = df.run_experiment(
        df.FlowConfig(train=df.TrainConfig(epochs=1, verbose=False),
                      family="rqs", n_blocks=1), x, th)
    np.testing.assert_array_equal(np.asarray(dset.partition.training),
                                  np.asarray(jdata.partition.training))
    # the precision and memory options reach train() as they are
    seen = {}
    real_train = sys.modules["densityflows_tpu_torch.train"].train

    def spy(*a, **kw):
        seen.update(remat=kw["remat"], mixed_precision=kw["mixed_precision"])
        return real_train(*a, **kw)

    for name in ("mixed_precision", "remat"):
        cfg = dt.FlowConfig(train=dt.TrainConfig(epochs=1, verbose=False,
                                                 **{name: True}))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sys.modules["densityflows_tpu_torch.train"], "train",
                       spy)
            flow, _, _ = dt.run_experiment(
                cfg, x, th, generator=torch.Generator().manual_seed(0),
                device="cpu")
        assert seen[name] is True and flow.trained_path == "torch"


@pytest.mark.parametrize("fn,kw", [
    ("two_moons", dict(n=501, rng=3)),
    ("two_moons", dict(n=64, noise=0.3, rng=np.random.default_rng(7))),
    ("rings", dict(n=500, rng=1)),
    ("rings", dict(n=301, radii=(0.5, 1.0, 3.0), noise=0.2, rng=9)),
])
def test_datasets_equal_jax_bit_for_bit(fn, kw):
    kw_j = dict(kw)
    if isinstance(kw["rng"], np.random.Generator):
        kw_j["rng"] = np.random.default_rng(7)
    got = getattr(tds, fn)(**kw)
    want = getattr(jds, fn)(**kw_j)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    dist = (tds.moons_manifold_distance(got) if fn == "two_moons"
            else tds.rings_manifold_distance(got, kw.get("radii", (1.0, 2.0))))
    want_dist = (jds.moons_manifold_distance(want) if fn == "two_moons"
                 else jds.rings_manifold_distance(want,
                                                  kw.get("radii", (1.0, 2.0))))
    np.testing.assert_array_equal(dist, want_dist)
