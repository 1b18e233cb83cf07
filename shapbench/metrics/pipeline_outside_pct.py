"""Layer "pipeline" (``pipeline/run_shap.py``, ``core/store.py``): the share
of the untraced timed call spent outside the clips' group steps, 100 x
(1 - the sum of the result dicts' ``wall_s`` / the call's wall): staging
the audio, the params' host copy for crash recovery, store writes, the
manifest. Host clock (``program_span``: the pipeline's own ``wall_s``).
Moves ``passes_per_s``."""

UNIT = "%"


def read(w):
    if not w.results or w.window_s <= 0:
        return None
    inside = sum(r["wall_s"] for r in w.results)
    return 100.0 * (1.0 - inside / w.window_s)
