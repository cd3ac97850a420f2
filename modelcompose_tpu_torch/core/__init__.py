from .llama import KVCache, forward, init_params  # noqa: F401
from .packing import assemble_embeds, plan_pack  # noqa: F401
# core.generate stays a module (re-exporting the function of the same name
# would shadow the submodule for `from ..core import generate` users).
