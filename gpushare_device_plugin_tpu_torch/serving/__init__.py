"""The slot-pool continuous-batching engine and its step profiler."""
