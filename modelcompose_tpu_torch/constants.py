"""Model- and serving-level constants (the port's copy of
modelcompose_tpu/constants.py).

Mirrors the reference vocabulary of modal placeholder tokens so that datasets,
checkpoints and prompts remain interoperable (reference:
modelcompose/constants.py:1-31).
"""

CONTROLLER_HEART_BEAT_EXPIRATION = 30
WORKER_HEART_BEAT_INTERVAL = 15

LOGDIR = "."

# Model constants
IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"

# Modal constants.  Placeholder tokens are spliced into prompts as negative
# token ids so they can never collide with real vocabulary entries.
MODAL_TOKENS = {
    "vision": DEFAULT_IMAGE_TOKEN,
    "relrep": "<relrep>",
    "text": "<text>",
    "audio": "<audio>",
    "video": "<video>",
    "point": "<point>",
}
MODAL_TOKEN_INDEXES = {
    "vision": -200,
    "relrep": -201,
    "text": -202,
    "audio": -203,
    "video": -204,
    "point": -205,
}
MODAL_TOKEN_MAPPING = {MODAL_TOKENS[k]: MODAL_TOKEN_INDEXES[k] for k in MODAL_TOKENS}

# Canonical modality ordering used for the stacked-adapter axis.  Must match
# the reference's infer_modals() enumeration order (reference:
# modelcompose/model/multimodal_encoder/builder.py:121-133): default first,
# then audio, vision, video, point.
CANONICAL_MODALITIES = ("audio", "vision", "video", "point")
DEFAULT_ADAPTER = "default"
