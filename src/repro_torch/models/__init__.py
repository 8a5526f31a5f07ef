"""Model stack of the port: the hybrid family (RecurrentGemma) so far."""
from .model import Model, build, n_params

__all__ = ["Model", "build", "n_params"]
