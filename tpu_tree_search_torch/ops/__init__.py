"""Device selection, instance tables, the CUDA kernel wrappers with their
plain PyTorch versions, and survivor compaction."""
