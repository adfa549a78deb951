"""Results layer: the numpy InferenceData container and its packing, the
chain-trace protocol (MultiTrace) and the durable FileTrace (the names of
`pymc_tpu/backends/__init__.py`; the zarr store is not ported)."""

from .arviz import to_inference_data
from .base import ChainRecordAdapter, IBaseTrace, MultiTrace, NDArray
from .checkpoint import FileTrace
from .inference_data import DataVar, Dataset, InferenceData

__all__ = [
    "to_inference_data", "DataVar", "Dataset", "InferenceData",
    "IBaseTrace", "NDArray", "MultiTrace", "ChainRecordAdapter", "FileTrace",
]
