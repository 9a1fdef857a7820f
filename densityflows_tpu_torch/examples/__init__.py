"""Worked examples of the PyTorch / CUDA port, one counterpart of each
``examples/*.py`` of the JAX package. Each module has ``main(device=None)``
(``None``: the CUDA device) that prints what it measured and returns the
numbers as a dict; run one as

    python -m densityflows_tpu_torch.examples.<name> [--device cpu]
"""

NAMES = ("conditional_density", "large_dataset_training", "multihost_dp",
         "sbi_posterior", "toy_densities", "uncertainty_and_mcmc")
