"""Results layer: the numpy InferenceData container and its packing."""
