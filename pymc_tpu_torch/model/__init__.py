from .core import Deterministic, Model, modelcontext

__all__ = ["Model", "modelcontext", "Deterministic"]
