"""The journal and the reservation ledger the port's protocols run on, and
the device plugin's placement: the binpack policy, the env a granted
container receives, the standalone allocator, and cluster mode's
apiserver-backed allocators."""
