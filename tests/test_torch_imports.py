"""The PyTorch port stands alone: it imports torch and numpy, never jax,
optax or the JAX package; and it runs on a CUDA device unless the caller asks
for the CPU."""

import ast
import os
import subprocess
import sys

import _torch_cpu  # noqa: F401

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
# mesh= on serving, tensor parallelism and the instruments (A9, A.4)
from densityflows_tpu_torch.parallel import scaling as port_scaling
from densityflows_tpu_torch.utils import profiling as port_profiling
assert tflow.sample((2,), (0.5,), mesh=dt.make_mesh(),
                    generator=g).shape == (2, 4)
assert torch.equal(tflow.log_prob(xs, ths, mesh=dt.make_mesh()),
                   tflow.log_prob(xs, ths))
assert port_mesh.shard_params_tp(dt.make_mesh(), chain) is not chain
assert port_mesh.mlp_tp_specs(2)[0] == [(None, "model"), ("model", None)]
timer = port_profiling.StepTimer()
with timer.step(tflow.log_prob(xs, ths)):
    pass
assert timer.p50_ms >= 0.0
# the other bases, spline / MAF / IAF / embedded flows, the config builders
# and the toy data sets
from densityflows_tpu_torch.utils import datasets as port_datasets
from densityflows_tpu_torch.ops import made, spline
moons = port_datasets.two_moons(64, rng=0)
for family in ("rqs", "maf"):
    cfg = dt.FlowConfig(train=dt.TrainConfig(epochs=1, batchsize=16,
                                             verbose=False),
                        family=family, n_blocks=1)
    mflow, _, _ = dt.run_experiment(cfg, moons, generator=g, device="cpu")
    assert np.isfinite(mflow.train_loss).all()
bases = (dt.DiagNormal(np.zeros(4, np.float32), np.ones(4, np.float32)),
         dt.GaussianMixture(np.zeros((2, 4), np.float32),
                            np.ones((2, 4), np.float32),
                            np.zeros(2, np.float32)),
         dt.BoxUniform(-np.ones(4, np.float32), np.ones(4, np.float32)))
for base in bases:
    bflow = dt.Flow(chain, flow.metadata, base, device="cpu")
    assert bflow.sample((3,), (0.5,), generator=g).shape == (3, 4)
emb = dt.embed_conditions(dt.flow_chain(
    dt.iaf_layer(4, n=2, generator=g, device="cpu"),
    dt.maf_layer(4, n=2, generator=g, device="cpu")), 1, 2, generator=g,
    device="cpu")
eflow = dt.Flow(emb, flow.metadata, device="cpu")
assert eflow.log_prob(np.zeros((5, 4), np.float32), (0.5,)).shape == (5,)
# the inference engine and the distributed resampler
from densityflows_tpu_torch import inference
from densityflows_tpu_torch.parallel import resample
samples, diag = dt.flow_mcmc(flow, lambda x: -(x * x).sum(-1), theta=(0.5,),
                             n_chains=8, n_steps=6, burn_in=1, generator=g)
assert samples.shape == (5, 8, 4) and diag["r_hat"].shape == (4,)
particles, log_w, _ = dt.run_smc(lambda x: -(x * x).sum(-1), 2, 64,
                                 n_steps=2, generator=g, device="cpu")
assert dt.systematic_resample_sharded(log_w, particles, g,
                                      dt.make_mesh()).shape == (64, 2)
# sharded checkpoints (torch.distributed.checkpoint) in one process
import tempfile
from densityflows_tpu_torch.utils import orbax_ckpt
with tempfile.TemporaryDirectory() as tmp:
    orbax_ckpt.save_flow_orbax(tmp, tflow, state)
    back, back_state = orbax_ckpt.load_flow_orbax(tmp, dt.adam(),
                                                  device="cpu")
assert torch.equal(back.log_prob(xs, ths), tflow.log_prob(xs, ths))
assert back_state.count == state.count
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
        lambda: orbax_ckpt.load_flow_orbax("/nonexistent"),
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
    assert len(sources) > 24
    names = {os.path.relpath(p, ROOT) for p in sources}
    for module in ("train.py", "models/fused_train.py",
                   "ops/train_kernels.py", "utils/logging.py", "convert.py",
                   "utils/checkpoint.py", "data_stream.py",
                   "native/__init__.py", "ops/step_kernels.py",
                   "ops/stream_kernels.py", "parallel/mesh.py",
                   "parallel/__init__.py", "ops/coupling_kernels.py",
                   "models/distributions.py", "ops/spline.py", "ops/made.py",
                   "models/autoregressive.py", "models/embedding.py",
                   "utils/datasets.py", "utils/config.py",
                   "inference.py", "parallel/resample.py", "ensemble.py",
                   "examples/__init__.py",
                   "examples/uncertainty_and_mcmc.py",
                   "utils/orbax_ckpt.py"):
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


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_every_port_test_process_runs_one_cpu_thread():
    """The one-thread rule lives in ``tests/_torch_cpu.py``: every test module
    of the port imports it at its top (directly or through
    ``_torch_parity``), and so does every worker those tests start, so a file
    run alone runs as it does beside others."""
    tests = os.path.join(ROOT, "tests")
    files = sorted(f for f in os.listdir(tests) if f.endswith(".py") and (
        f.startswith("test_torch_")
        or f.startswith("_torch_") and f.endswith("_worker.py")))
    assert len(files) > 33
    assert "_torch_cpu" in _top_level_imports(
        os.path.join(tests, "_torch_parity.py"))
    via = {"_torch_cpu", "_torch_parity"}
    missing = [f for f in files
               if not via & _top_level_imports(os.path.join(tests, f))]
    assert not missing, missing
    import torch

    assert torch.get_num_threads() == 1


def test_kernel_sources_are_package_data():
    src = os.path.join(ROOT, "densityflows_tpu_torch", "csrc",
                       "chain_kernels.cu")
    with open(src) as f:
        text = f.read()
    # the tensor-core fold lies in the header it shares with coupling_fwd
    assert '#include "wgmma_fold.cuh"' in text
    with open(os.path.join(os.path.dirname(src), "wgmma_fold.cuh")) as f:
        text += f.read()
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
    # no header of the package but the cp.async one and the tensor-core
    # fold it shares with the chain kernels (package data beside it), no
    # library
    quoted = [line.split('"')[1] for line in text.splitlines()
              if line.startswith("#include \"")]
    assert quoted == ["async_copy.cuh", "wgmma_fold.cuh"]
    assert all(os.path.exists(os.path.join(csrc, name)) for name in quoted)
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


def test_inference_surface_is_the_jax_packages():
    """Every public name of JAX ``inference`` and ``parallel.resample`` but
    the jit-cache pair, on the modules and the package."""
    import densityflows_tpu.inference as jinf
    import densityflows_tpu.parallel.resample as jres

    import densityflows_tpu_torch as dt
    from densityflows_tpu_torch import inference
    from densityflows_tpu_torch.parallel import resample

    not_ported = {"clear_caches", "trace_counts"}
    assert set(inference.__all__) == set(jinf.__all__) - not_ported
    assert resample.__all__ == jres.__all__
    for module in (inference, resample):
        for name in module.__all__:
            assert getattr(dt, name) is getattr(module, name), name
            assert name in dt.__all__, name
    for name in not_ported:
        assert not hasattr(inference, name) and not hasattr(dt, name)


def test_the_package_surface_is_the_jax_packages_but_clear_caches():
    """Every public name of the JAX package is the port's, but one left out
    on purpose: ``clear_caches`` empties the JAX package's jit program
    caches, and eager PyTorch compiles no program to cache (ROADMAP A.7)."""
    import densityflows_tpu as jdf

    import densityflows_tpu_torch as dt

    assert set(jdf.__all__) - set(dt.__all__) == {"clear_caches"}
    for name in ("EnsembleFlow", "stack_models", "train_ensemble",
                 "save_ensemble", "load_ensemble", "cast_conditioners"):
        assert name in dt.__all__ and callable(getattr(dt, name)), name
    assert not hasattr(dt, "clear_caches")
    from densityflows_tpu_torch import examples

    assert set(examples.NAMES) == {
        os.path.splitext(f)[0] for f in os.listdir(os.path.join(ROOT,
                                                                "examples"))
        if f.endswith(".py")}


def _literal_all(path):
    """The ``__all__`` list a module assigns, read from its source."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} assigns no __all__")


def test_instrument_modules_export_the_jax_names():
    for module in ("utils/profiling.py", "parallel/scaling.py"):
        port = _literal_all(os.path.join(ROOT, "densityflows_tpu_torch",
                                         module))
        ref = _literal_all(os.path.join(ROOT, "densityflows_tpu", module))
        assert port == ref, module


def test_sharded_checkpoint_module_exports_the_jax_names():
    """``utils/orbax_ckpt.py``, the last module of the JAX package the port
    lacked, keeps its module and function names."""
    port = _literal_all(os.path.join(ROOT, "densityflows_tpu_torch", "utils",
                                     "orbax_ckpt.py"))
    ref = _literal_all(os.path.join(ROOT, "densityflows_tpu", "utils",
                                    "orbax_ckpt.py"))
    assert port == ref == ["save_flow_orbax", "load_flow_orbax"]


def test_no_module_refuses_a9_or_tensor_parallelism():
    """The mesh surfaces of A9 (``mesh=`` on serving and the inference
    engine, tensor parallelism) are ported: no source of the port raises
    ``NotImplementedError`` citing them."""
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Raise)
                    and isinstance(node.exc, ast.Call)
                    and getattr(node.exc.func, "id", "")
                    == "NotImplementedError"):
                continue
            text = " ".join(c.value for c in ast.walk(node.exc)
                            if isinstance(c, ast.Constant)
                            and isinstance(c.value, str)).lower()
            for word in ("a9", "tensor parallel", "mesh"):
                assert word not in text, (path, node.lineno, text)
