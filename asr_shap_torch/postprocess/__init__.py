from asr_shap_torch.postprocess.attribution import (
    block_mean_smooth,
    char_group_frames,
    character_masks,
    frame_to_sample_interp,
    normalize_and_scale,
    repeat_upsample,
)

__all__ = [
    "block_mean_smooth",
    "char_group_frames",
    "character_masks",
    "frame_to_sample_interp",
    "normalize_and_scale",
    "repeat_upsample",
]
