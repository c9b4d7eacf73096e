"""Image and checkpoint output: PNG/npy dumps and resumable accumulators."""
