"""Named model configurations of the port.

``mcub4_damc_7b``: the MCUB-4 composition (image, audio, video and point
DAMC checkpoints merged with online-merge-reset at 0.25 each) at Vicuna-7B
width.  Sources: ``scripts/model_composition/test/MCUB-4.sh``, the four
``scripts/model_composition/train/run_finetune_{vision,audio,video,
point}_damc.sh`` recipes (towers, projectors, LoRA r=128 / alpha 256, 5+5
soft tokens) and ``bench.py::_composed_cfg``.  The recipes' audio
projector is the 32-query Q-Former, so audio spans 32 + 10 positions
(``_composed_cfg`` leaves the projectors at ``linear``, which would give
BEATs' 512 tokens).  The tower specs name the released checkpoints; where
they are not on disk the towers are random.
"""

from __future__ import annotations

from .config import ModelConfig

MCUB4_RESET = ("default-vision=0.25,default-audio=0.25,default-video=0.25,"
               "default-point=0.25")

# Per-modality recipe settings: tower, its output width, projector.
MCUB4_TOWERS = {
    "vision": dict(mm_vision_encoder="openai/clip-vit-large-patch14-336",
                   mm_hidden_size=1024, mm_projector_type="mlp2x_gelu",
                   mm_vision_select_layer=-2),
    "audio": dict(mm_audio_encoder="BEATs_iter3_plus_AS2M.pt",
                  mm_audio_hidden_size=768,
                  mm_audio_projector_type="qformer_32N_2L"),
    "video": dict(mm_video_encoder="LanguageBind_Video_merge",
                  mm_video_hidden_size=1024,
                  mm_video_projector_type="mlp2x_gelu",
                  mm_video_select_layer=-2),
    "point": dict(mm_point_encoder="point_bert_v1.2.pt",
                  mm_point_hidden_size=384,
                  mm_point_projector_type="mlp2x_gelu"),
}

# Packed positions of each modality in an MCUB-4 prompt: its projector
# output plus 5 + 5 soft tokens (bench.py:171-180; about 70 text tokens
# come on top).
MCUB4_SPANS = {"vision": 576 + 10, "audio": 32 + 10, "video": 8 * 257 + 10,
               "point": 513 + 10}


def damc_unimodal(modal: str, **overrides) -> ModelConfig:
    """One modality's DAMC stage-2 checkpoint config at Vicuna-7B width."""
    kw = dict(lora_strategy="modal+language", lora_r=128, lora_alpha=256,
              local_prefix_tokens=5, local_suffix_tokens=5, dtype="bfloat16",
              **MCUB4_TOWERS[modal])
    kw.update(overrides)
    return ModelConfig(**kw)


def mcub4_damc_7b(**overrides) -> ModelConfig:
    """The merged MCUB-4 config: 4 towers, 9 stacked adapter rows
    (default, the four modalities, the four default-{modal} rows)."""
    kw = dict(lora_strategy="modal+language", lora_r=128, lora_alpha=256,
              local_prefix_tokens=5, local_suffix_tokens=5, dtype="bfloat16",
              reset_scaling_weights=MCUB4_RESET)
    for towers in MCUB4_TOWERS.values():
        kw.update(towers)
    kw.update(overrides)
    return ModelConfig(**kw)
