"""Model stack of the port: the dense (Qwen2, SmolLM), hybrid
(RecurrentGemma) and SSM (Mamba-2) families so far."""
from .model import Model, build, n_params

__all__ = ["Model", "build", "n_params"]
