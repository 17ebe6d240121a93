"""The journal and the claim ledger the port's protocols run on, and the
device plugin's placement: the binpack policy, the env a granted
container receives, and the standalone allocator."""
