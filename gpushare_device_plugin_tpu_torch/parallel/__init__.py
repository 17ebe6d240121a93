"""The pod's injected env (``podenv``) and the attention math shared across
the port: the single-device part of the reference's ``parallel``."""
