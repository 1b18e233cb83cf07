"""Traffic: the clips a cell explains, made from ``--seed`` by one general
generator (``generate.py``) from the parameters in the cell's file.

Frozen copies, so that no later change to the port moves the yardstick:
``prng.py`` (the port's stream derivation, ``asr_shap_torch/core/prng.py``),
``speech.py`` (its text-conditional synthetic speech,
``asr_shap_torch/pipeline/testset.py``), ``noise.py`` (white noise at an
SNR, ``asr_shap_torch/audio/noise.py``).
"""
