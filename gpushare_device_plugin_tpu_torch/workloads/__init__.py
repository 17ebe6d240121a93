"""The decoder, its weights, its caches, generation and training, in PyTorch."""
