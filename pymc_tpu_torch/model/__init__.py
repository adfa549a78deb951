from .core import (
    BaseModel, Deterministic, FrozenModel, Model, Point, Potential, compile, compile_fn,
    modelcontext, set_data,
)

__all__ = [
    "Model", "modelcontext", "Deterministic", "Potential", "Point", "compile_fn", "compile",
    "set_data", "BaseModel", "FrozenModel",
]
