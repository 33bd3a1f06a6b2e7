"""Model code of the port (counterparts of ``repro/models``)."""
from .model import Model, init_params, make_model

__all__ = ["Model", "init_params", "make_model"]
