"""Hand-written CUDA kernels for the port's hot spots, built from
``csrc/`` at first use (:mod:`repro_torch.kernels.build`).

* ``spmv`` — the stacked Block-ELL SpMM (the PMVC), replacing the JAX
  package's Pallas ``bell_spmm``.
"""
