"""Command-line entry points: the node agent's daemon (``daemon``), the
inspect CLI (``inspect``) and the kubelet pod-list dump (``podgetter``)."""
