"""The port's examples (``densityflows_tpu_torch/examples``) run on the CPU.

One counterpart of each ``examples/*.py`` of the JAX package. As the JAX
suite's ``tests/test_docs_examples.py`` clamps the work of the docs
(``_BUDGETS``), the examples run against the real package with the
work-budget arguments of the expensive entry points clamped (epochs,
members, steps, particles, draws); everything else — data, widths, the
calls and their order — is the example's own. ``multihost_dp`` starts two
gloo ranks as subprocesses, one epoch each.
"""

import functools
import importlib

import numpy as np
import pytest

import densityflows_tpu_torch as dt_real
from densityflows_tpu_torch import examples

import _torch_cpu  # noqa: F401

# per-function work-budget clamps: kwarg -> (cap, default_if_absent)
_BUDGETS = {
    "train": {"epochs": (1, 1)},
    "train_ensemble": {"epochs": (2, 2), "n_members": (2, 2)},
    "fit_posterior": {"epochs": (2, 2)},
    "fit_posterior_apt": {"epochs": (2, 2)},
    "run_smc": {"n_particles": (512, 512), "n_steps": (8, 8)},
    "flow_mcmc": {"n_steps": (12, 12), "n_chains": (16, 16),
                  "burn_in": (6, 6)},
    "sbc_ranks": {"n_draws": (16, 16)},
}


class _BudgetedAPI:
    """Pass-through proxy over the package: the expensive entry points get
    their work-budget arguments clamped."""

    def __getattr__(self, name):
        v = getattr(dt_real, name)
        caps = _BUDGETS.get(name)
        if caps is None or not callable(v):
            return v

        @functools.wraps(v)
        def wrapped(*args, **kw):
            for k, (cap, dflt) in caps.items():
                if k in kw and isinstance(kw[k], int):
                    kw[k] = min(kw[k], cap)
                elif k not in kw:
                    kw[k] = dflt
            return v(*args, **kw)

        return wrapped


def _numbers(out):
    """Every number in an example's result, flattened."""
    if isinstance(out, dict):
        return [v for x in out.values() for v in _numbers(x)]
    if isinstance(out, (list, tuple)):
        return [v for x in out for v in _numbers(x)]
    if isinstance(out, (int, float, np.floating)) and not isinstance(
            out, bool):
        return [float(out)]
    return []


@pytest.mark.parametrize("name", examples.NAMES)
def test_example_runs_on_the_cpu_with_clamped_budgets(name, monkeypatch,
                                                      capsys):
    module = importlib.import_module(f"densityflows_tpu_torch.examples.{name}")
    monkeypatch.setattr(module, "dt", _BudgetedAPI())
    if name == "multihost_dp":
        out = module.main(device="cpu", epochs=1)
        assert out == dict(world=2, exit_codes=[0, 0])
    else:
        out = module.main(device="cpu")
    printed = capsys.readouterr().out
    assert printed.strip()
    values = _numbers(out)
    assert values
    if name == "toy_densities":
        # the background box holds points the moons flow may send to an
        # exp() overflow: only the manifold's numbers are held finite
        values = [v for k in ("moons", "rings") for key, v in out[k].items()
                  if key in ("train_nll", "cover", "lp_data")]
    assert np.isfinite(values).all(), out
    if name == "uncertainty_and_mcmc":
        assert out["trained_path"] == "torch"
        assert len(out["final_nll"]) == 2
    if name == "large_dataset_training":
        assert out["decline_reason"] == "non-CUDA device (cpu)"
