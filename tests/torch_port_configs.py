"""Configurations shared by the port's parity tests (tests/test_torch_*.py).
Imported by module name: pytest puts this directory on sys.path for the
test modules beside it."""

import dataclasses

from asr_shap.core.config import Wav2Vec2Config as JaxWav2Vec2Config
from asr_shap_torch.core import config as port_config


def narrow_config(**kw):
    """Conv widths of 128, so the dgrad kernel's Function is on the path;
    the projection's norm width is the last conv width."""
    return JaxWav2Vec2Config(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=128, conv_dim=(128, 128, 128), conv_stride=(5, 2, 2),
        conv_kernel=(10, 3, 2), num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, feat_proj_dim=128,
        attention_impl="pallas", conv_impl="pallas", **kw)


def port_cfg(cfg):
    """The port's twin of a reference Wav2Vec2Config."""
    return port_config.Wav2Vec2Config(**dataclasses.asdict(cfg))
