from .model import MultimodalLM  # noqa: F401
