"""PyTorch and CUDA port of the pod-side serving and training paths of
``gpushare_device_plugin_tpu``, and of its device plugin's own path on a
node (discovery, fan-out, allocation, health, the gRPC server), for one
NVIDIA H100.

The JAX package is the reference; module names here mirror it. This
package imports ``torch`` and ``numpy`` (the plugin's gRPC layer also
``grpc`` and ``protobuf``) and nothing of JAX or of the reference
package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see :func:`.device.resolve_device`).
"""

__version__ = "0.1.0"
