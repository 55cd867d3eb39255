"""Parallel training of the port: the process mesh (``mesh``), the ring
transport (``peer``) and the context-parallel train step (``hybrid``)."""
