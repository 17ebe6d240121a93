"""The decoder, its weights, its caches and generation, in PyTorch."""
