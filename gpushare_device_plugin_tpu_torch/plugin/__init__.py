"""The device plugin's gRPC server: the kubelet-facing half of the node
agent."""

from .server import PluginConfig, TpuSharePlugin, wait_for_socket

__all__ = ["PluginConfig", "TpuSharePlugin", "wait_for_socket"]
