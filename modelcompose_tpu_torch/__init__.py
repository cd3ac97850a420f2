"""modelcompose-tpu, PyTorch port: the multimodal composition runtime on
CUDA (NVIDIA Hopper), held against the JAX package ``modelcompose_tpu``.

The port mirrors the JAX package's module paths and public names.  Its
attention kernels (flash-attention forward and backward, flash-decode) are
written by hand for ``sm_90a`` (``csrc/``); every other op is plain
PyTorch.  On a CPU tensor each kernel wrapper runs the
kernel's plain PyTorch version, so the whole port runs (slowly) on the CPU.

Public API:
    from modelcompose_tpu_torch import ModelConfig, MultimodalLM

The package imports ``torch`` and never ``jax``, and nothing of the JAX
package: what it needs of the JAX package's framework-free modules
(``config``, ``constants``, ``compose.state_io``, ``compose.ties``, the
audio and video processors) it keeps as its own copies.
"""

from .config import ModelConfig, tiny_test_config  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    if name == "MultimodalLM":
        from .models.model import MultimodalLM
        return MultimodalLM
    raise AttributeError(name)
