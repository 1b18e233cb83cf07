"""The plain reference: float32 PyTorch forwards of each model family
(``<family>.py``, found by the ``family`` key of a configuration file) and
expected gradients over given draws (``expected_gradients.py``).

It imports neither ``jax``, ``asr_shap`` nor ``asr_shap_torch``, and takes
nothing that the program made: the weights come from ``shapbench.params``,
the background rows and draws from the frozen stream derivation in
``shapbench.traffic.prng``. A ``Precision`` below float32 ("tf32", "fp8")
rounds every matmul and convolution operand, forward and backward: the
control that must come out as not correct.
"""
