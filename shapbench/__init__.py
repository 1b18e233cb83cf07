"""The benchmark of ``asr_shap_torch``, the PyTorch and CUDA port.

``python -m shapbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository root; see ``README.md``. Nothing here
imports ``jax`` or the JAX package ``asr_shap``; the port is imported only
by ``run.py`` and ``calibrate.py``, inside functions.
"""
