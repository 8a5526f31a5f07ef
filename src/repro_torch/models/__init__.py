"""Model stack of the port: every family of ``configs.ARCHS`` (dense,
MoE, encoder-decoder, hybrid, SSM), the port's own Nemotron-H
(``configs.PORT_ARCHS``) and the frontend stubs."""
from .model import Model, build, n_params

__all__ = ["Model", "build", "n_params"]
