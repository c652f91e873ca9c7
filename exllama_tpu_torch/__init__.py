"""exllama_tpu_torch: the PyTorch/CUDA port of exllama_tpu for one NVIDIA
H100 (Hopper, sm_90a).

The JAX package ``exllama_tpu`` stays beside it as the reference; this
package imports nothing of it and nothing of JAX. Every kernel on its path
is hand-written CUDA C++ under ``csrc/``, built by ``nvcc`` at first use
(``exllama_tpu_torch.kernels``); on CPU tensors each kernel wrapper runs its
plain PyTorch version instead. Entry points default to ``device="cuda"``.
"""

from exllama_tpu_torch.alt_generator import ExLlamaAltGenerator
from exllama_tpu_torch.cache import ExLlamaCache
from exllama_tpu_torch.config import ExLlamaConfig, TuningParams
from exllama_tpu_torch.formats.loader import (
    load_model_params,
    make_synthetic_params,
    params_from_jax,
)
from exllama_tpu_torch.generator import ExLlamaGenerator
from exllama_tpu_torch.lora import ExLlamaLora
from exllama_tpu_torch.models.llama import ExLlama
from exllama_tpu_torch.speculative import SpeculativeGenerator
from exllama_tpu_torch.tokenizer import ExLlamaTokenizer, FakeTokenizer
from exllama_tpu_torch.version import __version__

__all__ = [
    "ExLlama",
    "ExLlamaAltGenerator",
    "ExLlamaCache",
    "ExLlamaConfig",
    "ExLlamaGenerator",
    "ExLlamaLora",
    "ExLlamaTokenizer",
    "FakeTokenizer",
    "SpeculativeGenerator",
    "TuningParams",
    "__version__",
    "load_model_params",
    "make_synthetic_params",
    "params_from_jax",
]
