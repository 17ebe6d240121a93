"""Command-line entry points: the node agent's daemon (``daemon``)."""
