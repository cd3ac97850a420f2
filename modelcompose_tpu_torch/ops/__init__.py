# Functions named like their modules (attention, flash_attention) are not
# re-exported here, so ``from modelcompose_tpu_torch.ops import attention``
# is the module.
from .attention import attention_reference, decode_attention  # noqa: F401
from .norms import rms_norm  # noqa: F401
from .quant import quantize_backbone, quantize_int8  # noqa: F401
from .rope import apply_rope, rope_tables  # noqa: F401
from .routed_lora import routed_lora_matmul  # noqa: F401
