"""The PyTorch port stands alone: it imports torch and numpy, never jax,
optax or the JAX package; and it runs on a CUDA device unless the caller asks
for the CPU."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "optax", "densityflows_tpu", "flax", "orbax")

_PROBE = r"""
import sys
import numpy as np
import torch
import densityflows_tpu_torch as dt

g = torch.Generator().manual_seed(0)
chain = dt.flow_chain(
    dt.coupling_block(4, None, n=1, generator=g, device="cpu",
                      hidden_dim_s=8, hidden_dim_t=8, zero_init_final=False),
    dt.normalization_layer(np.linspace(-2, 2, 12, dtype=np.float32
                                       ).reshape(3, 4), -1.0, 1.0,
                           device="cpu"))
flow = dt.Flow(chain, dt.MetaData("", 4, 1, np.zeros(1), np.ones(1)),
               device="cpu")
lp = flow.log_prob(np.zeros((5, 4), np.float32), (0.5,))
assert lp.shape == (5,) and bool(torch.isfinite(lp).all())

# training on the CPU: the plain program and the kernel's plain version
rng = np.random.default_rng(0)
data = dt.DataArrays.make(rng.normal(size=(60, 4)).astype(np.float32),
                          rng.uniform(size=(60, 1)).astype(np.float32), rng=0)
tflow = dt.Flow(chain, data, device="cpu")
for fused in (False, True):
    state = dt.train(tflow, data, epochs=1, batchsize=16, verbose=False,
                     generator=g, fused_kernel=fused)
assert state.count == 4 and tflow.trained_path == "fused"
assert len(tflow.train_loss) == 2 and np.isfinite(tflow.train_loss).all()
from densityflows_tpu_torch.ops import train_kernels
from densityflows_tpu_torch.models import fused_train
from densityflows_tpu_torch.utils import logging as port_logging
assert train_kernels.run_fused_train.launches == 0

# streaming and data-parallel training on the CPU: the native loader (or its
# fallback), the step kernel's plain version, the trivial mesh
from densityflows_tpu_torch import data_stream, native
from densityflows_tpu_torch.ops import step_kernels
from densityflows_tpu_torch.parallel import mesh as port_mesh
xs = rng.normal(size=(60, 4)).astype(np.float32)
ths = rng.uniform(size=(60, 1)).astype(np.float32)
state = dt.train_streaming(tflow, xs, ths, epochs=1, batchsize=16,
                           verbose=False, fused_kernel=True)
assert state.count == 4 and tflow.trained_path == "fused-step"
state = dt.train(tflow, data, epochs=1, batchsize=16, verbose=False,
                 generator=g, mesh=dt.make_mesh(), fused_kernel=True)
assert tflow.trained_path == "fused-step-mesh"
assert step_kernels.run_fused_grads.launches == 0
assert isinstance(native.native_available(), bool)
# mesh= is ported for training only, and tensor parallelism not at all
for call in (lambda: tflow.sample((2,), (0.5,), mesh=dt.make_mesh()),
             lambda: tflow.log_prob(xs, ths, mesh=dt.make_mesh()),
             lambda: port_mesh.shard_params_tp(dt.make_mesh(), chain),
             lambda: port_mesh.mlp_tp_specs(2)):
    try:
        call()
    except NotImplementedError as e:
        assert "mesh" in str(e) or "tensor parallelism" in str(e), e
    else:
        raise AssertionError("an unported mesh surface did not raise")
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "optax", "densityflows_tpu",
                              "flax", "orbax")]
assert not bad, bad

# device=None means "cuda": where there is no CUDA that raises
if not torch.cuda.is_available():
    for call in (
        lambda: dt.Flow(chain, flow.metadata),
        lambda: dt.coupling_layer(4, 2),
        lambda: dt.init_mlp(g, 2, 2),
        lambda: dt.normalization_layer(np.eye(3, dtype=np.float32) , 0., 1.),
        lambda: dt.load_flow("/nonexistent"),
        lambda: dt.resolve_device(None),
    ):
        try:
            call()
        except RuntimeError as e:
            assert "cuda" in str(e).lower(), e
        else:
            raise AssertionError("device=None ran without CUDA")
print("PROBE_OK")
"""


def test_import_and_cpu_log_prob_without_jax_in_a_fresh_process():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PROBE_OK" in proc.stdout


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT,
                                               "densityflows_tpu_torch")):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return out


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 19
    names = {os.path.relpath(p, ROOT) for p in sources}
    for module in ("train.py", "models/fused_train.py",
                   "ops/train_kernels.py", "utils/logging.py", "convert.py",
                   "utils/checkpoint.py", "data_stream.py",
                   "native/__init__.py", "ops/step_kernels.py",
                   "ops/stream_kernels.py", "parallel/mesh.py",
                   "parallel/__init__.py", "ops/coupling_kernels.py"):
        assert os.path.join("densityflows_tpu_torch", module) in names
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_kernel_sources_are_package_data():
    src = os.path.join(ROOT, "densityflows_tpu_torch", "csrc",
                       "chain_kernels.cu")
    with open(src) as f:
        text = f.read()
    for symbol in ("df_chain_apply", "df_chain_sample", "philox4x32_10",
                   "chain_apply_kernel", "chain_sample_kernel",
                   "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32",
                   "cvt.rna.tf32.f32"):
        assert symbol in text
    # the products are computed in the kernel's own body
    for library in ("cublas", "cutlass", "torch/extension.h"):
        assert library not in text.lower()


def test_train_kernel_source_is_package_data():
    src = os.path.join(ROOT, "densityflows_tpu_torch", "csrc",
                       "train_kernels.cu")
    with open(src) as f:
        text = f.read()
    for symbol in ("df_train_run", "train_run_kernel", "__global__"):
        assert symbol in text
    for library in ("cublas", "cudnn", "cutlass", "torch/extension.h"):
        assert library not in text.lower()
    # the emulation header is a file of the tests, which hand it to the
    # compiler themselves: the package's source names no file outside csrc/
    assert os.path.exists(os.path.join(ROOT, "tests",
                                       "cuda_host_emulation.h"))
    csrc = os.path.dirname(src)
    quoted = [line.split('"')[1] for line in text.splitlines()
              if line.startswith("#include \"")]
    assert quoted == ["flow_phases.cuh"]
    assert all(os.path.exists(os.path.join(csrc, name)) for name in quoted)


def test_step_kernel_and_loader_sources_are_package_data():
    csrc = os.path.join(ROOT, "densityflows_tpu_torch", "csrc")
    with open(os.path.join(csrc, "step_kernels.cu")) as f:
        text = f.read()
    for symbol in ("df_step_grads", "step_grads_kernel", "step_reduce_kernel",
                   "__global__"):
        assert symbol in text
    quoted = [line.split('"')[1] for line in text.splitlines()
              if line.startswith("#include \"")]
    assert quoted == ["async_copy.cuh", "flow_phases.cuh", "grads_tile.cuh"]
    assert all(os.path.exists(os.path.join(csrc, name)) for name in quoted)
    shared = ""
    for header in ("flow_phases.cuh", "grads_tile.cuh"):
        with open(os.path.join(csrc, header)) as f:
            shared += f.read()
    for library in ("cublas", "cudnn", "cutlass", "torch/extension.h",
                    "atomicadd"):
        assert library not in text.lower() and library not in shared.lower()
    # the host loader: the port's own copy, no file of the JAX package
    with open(os.path.join(csrc, "loader.cpp")) as f:
        loader = f.read()
    for symbol in ("df_shuffle", "df_gather_f32", "df_gather_f64",
                   "0x9E3779B97F4A7C15ULL"):
        assert symbol in loader
    pkg = os.path.join(ROOT, "densityflows_tpu_torch", "native")
    assert sorted(f for f in os.listdir(pkg) if not f.startswith("__py")) \
        == ["__init__.py"]


def test_coupling_kernel_source_is_package_data():
    csrc = os.path.join(ROOT, "densityflows_tpu_torch", "csrc")
    with open(os.path.join(csrc, "coupling_kernels.cu")) as f:
        text = f.read()
    for symbol in ("df_coupling_fwd", "df_coupling_bwd", "coupling_fwd_kernel",
                   "coupling_product_kernel", "coupling_pullback_kernel",
                   "coupling_bwd_reduce_kernel", "__global__"):
        assert symbol in text
    # a source of its own: no header of the package but the cp.async one
    # (package data beside it), no library
    quoted = [line.split('"')[1] for line in text.splitlines()
              if line.startswith("#include \"")]
    assert quoted == ["async_copy.cuh"]
    assert os.path.exists(os.path.join(csrc, "async_copy.cuh"))
    for library in ("cublas", "cudnn", "cutlass", "torch/extension.h",
                    "atomicadd"):
        assert library not in text.lower()
    with open(os.path.join(ROOT, "densityflows_tpu_torch", "ops",
                           "coupling_kernels.py")) as f:
        wrapper = f.read()
    assert 'load_library("coupling_kernels")' in wrapper


def test_build_module_needs_no_compiler_to_import():
    from densityflows_tpu_torch import _build

    assert "-gencode" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.source_path("chain_kernels").endswith(
        os.path.join("csrc", "chain_kernels.cu"))
    assert _build.source_path("train_kernels").endswith(
        os.path.join("csrc", "train_kernels.cu"))
    assert os.path.exists(_build.source_path("train_kernels"))
    assert os.path.exists(_build.source_path("step_kernels"))
    assert os.path.exists(_build.source_path("stream_kernels"))
    assert os.path.exists(_build.source_path("coupling_kernels"))
    assert _build.source_path("loader", ".cpp").endswith(
        os.path.join("csrc", "loader.cpp"))
    assert "-pthread" in _build.HOST_FLAGS
    assert os.path.basename(_build.build_dir()) == "build"
