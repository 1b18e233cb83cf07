"""The pluggable nonlinearities of the conformer blocks (``Rules``).

The same forward runs with plain ops, or with the DeepSHAP rescale ops of
``explain/deepshap.py`` on dual batches, where the batch axis carries the
(actual, reference) pair. ``models/w2v2_conformer.py`` takes a ``Rules``.
The mel Conformer of the reference's ``models/conformer.py`` is not ported
yet; it comes with the other model families (``ROADMAP.md`` queue 1).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F


class Rules(NamedTuple):
    """Pluggable nonlinearities: plain ops for inference, rescale ops for
    DeepSHAP's dual forwards."""

    silu: Callable
    glu: Callable  # (x, axis) -> gated half


def _plain_glu(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """a * sigmoid(b) of the two halves of ``x`` along ``axis``."""
    return F.glu(x, dim=axis)


PLAIN_RULES = Rules(silu=F.silu, glu=_plain_glu)


def deepshap_rules() -> Rules:
    from asr_shap_torch.explain.deepshap import glu_rescale, silu_rescale

    return Rules(silu=silu_rescale, glu=glu_rescale)
