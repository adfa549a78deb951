from .core import Deterministic, Model, Potential, modelcontext

__all__ = ["Model", "modelcontext", "Deterministic", "Potential"]
