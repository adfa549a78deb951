"""Variable type sets.

Counterpart of `pymc_tpu/vartypes.py` (reference pymc/vartypes.py). A
variable's dtype is matched by name: numpy's names and torch's without the
`torch.` prefix, so `torch.float32` and `np.float32` both count as
"float32".
"""

__all__ = [
    "bool_types",
    "int_types",
    "float_types",
    "complex_types",
    "continuous_types",
    "discrete_types",
    "typefilter",
    "isgenerator",
]

bool_types = {"int8", "bool", "bool_"}
int_types = {"int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64"}
float_types = {"float16", "float32", "float64", "bfloat16"}
complex_types = {"complex64", "complex128"}
continuous_types = float_types | complex_types
discrete_types = bool_types | int_types


def _dtype_name(v):
    return str(getattr(v, "dtype", "")).removeprefix("torch.")


def typefilter(vars, types):
    """The variables whose dtype is one of `types`."""
    return [v for v in vars if _dtype_name(v) in types]


def isgenerator(obj):
    import types

    return isinstance(obj, types.GeneratorType)
