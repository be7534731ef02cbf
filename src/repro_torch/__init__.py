"""SPAC on PyTorch and CUDA: the port of the JAX package ``repro``.

Each subpackage and module answers to the ``repro`` module of the same name.
The port runs single-switch scenarios from trace to verified Pareto front:
``repro_torch.api.run_scenario(registry["hft"])`` (or ``python -m
repro_torch run hft``), including hardware back-annotation and rung-4
escalation on the cycle-level switch (``repro_torch.switch``).  Stage 2's
crossbar scan, stage 4's port replay and the switch's iSLIP step and header
parser run as hand-written CUDA kernels on the card
(``repro_torch.kernels``); every other pass is PyTorch or host NumPy, as in
the reference.  The package never imports ``jax`` or ``repro``;
``repro_torch.convert`` rebuilds the reference's objects from their fields.
"""
