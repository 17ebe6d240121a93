"""Plain PyTorch references of the benchmark's configurations (no kernel,
cache or batching, float32 with TF32 off). They import nothing of the
program under test and take nothing it made: weights are drawn again from
the seed (``benchmark/weights.py``) and quantized here."""
