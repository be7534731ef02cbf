"""SPAC on PyTorch and CUDA: the port of the JAX package ``repro``.

Each subpackage and module answers to the ``repro`` module of the same name.
This slice holds the single-switch DSE from trace to verified Pareto front:
``repro_torch.core.dse.run_dse`` on a
``repro_torch.sim.switch_problem.SwitchDSEProblem`` (or the one-call
``optimize_switch``).  Stage 2's crossbar scan and stage 4's port replay run
as hand-written CUDA kernels on the card (``repro_torch.kernels``); every
other pass is host NumPy, as in the reference.  The package never imports
``jax`` or ``repro``; ``repro_torch.convert`` rebuilds the reference's
objects from their fields.
"""
