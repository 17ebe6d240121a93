"""The pod's injected env (``podenv``), the mesh over a ``torch.distributed``
world (``mesh``), its differentiable collectives (``collectives``), the
context-parallel attention schemes (``ring``, ``ulysses``) and the
attention math shared across the port: the reference's ``parallel``."""
