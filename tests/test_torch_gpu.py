"""Tests of the PyTorch port that need an NVIDIA GPU and nvcc: the CUDA chain
kernels against their plain versions. They skip where there is no card; run
them on a machine with one with

    python -m pytest tests/test_torch_gpu.py -m gpu -q

``chip_smoke.py`` makes the same comparisons at full width."""

import numpy as np
import pytest
import torch

import densityflows_tpu_torch as dt
from densityflows_tpu_torch.models import fused_chain as TF
from densityflows_tpu_torch.ops import chain_kernels as CK

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the chain kernels have no "
                    "interpret mode)")
    return torch.device("cuda")


def _chain(device, d=7, n=3, h=18):
    g = torch.Generator().manual_seed(0)
    x_ref = np.random.default_rng(0).normal(size=(64, d)).astype(np.float32)
    kw = dict(generator=g, device=device, zero_init_final=False,
              hidden_dim_s=h, hidden_dim_t=h)
    return dt.flow_chain(
        dt.coupling_block(d, None, n=n, **kw),
        dt.permutation_layer(d, generator=g),
        dt.coupling_layer(d, 3, n=n, kind=dt.NICECouplingLayer, **kw),
        dt.coupling_layer(d, 3, n=n, joint_conditioner=True,
                          max_log_scale=2.0, **kw),
        dt.normalization_layer(x_ref, -1.0, 1.0, device=device))


@pytest.mark.parametrize("dirn", ["fwd", "inv"])
def test_chain_apply_kernel_matches_plain(cuda, dirn):
    chain = _chain(cuda)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(1001, 7)).astype(np.float32)).to(cuda)
    th = torch.as_tensor(rng.uniform(size=(1001, 3)).astype(np.float32)).to(cuda)
    plan, params = TF._plan_params(chain, dirn)
    before = CK.run_chain.launches
    y, ldj = CK.run_chain(plan, params, x, th, with_ldj=True)
    torch.cuda.synchronize()
    assert CK.run_chain.launches == before + 1
    yr, lr = CK.chain_apply_plain(plan, params, x, th, with_ldj=True)
    # f32 FMA in another summation order than the library's products
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ldj, lr, rtol=1e-4, atol=1e-4)


def test_chain_sample_kernel_matches_plain_fold_of_its_noise(cuda):
    chain = _chain(cuda)
    plan, params = TF._plan_params(chain, "fwd")
    th = torch.full((1, 3), 0.5, device=cuda)
    y, r = CK.run_chain_sample(plan, params, 4097, 7, th, seed=7,
                               return_noise=True)
    torch.cuda.synchronize()
    ref = CK.chain_sample_plain(plan, params, 4097, 7, th, noise=r)
    torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(r.cpu().numpy(),
                               CK.philox_normal_reference(7, 4097, 7),
                               atol=1e-5)
