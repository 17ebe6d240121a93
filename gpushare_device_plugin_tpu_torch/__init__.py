"""PyTorch and CUDA port of the pod-side serving and training paths of
``gpushare_device_plugin_tpu``, for one NVIDIA H100.

The JAX package is the reference; module names here mirror it. This
package imports ``torch`` and ``numpy`` and nothing of JAX or of the
reference package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see :func:`.device.resolve_device`).
"""
