"""Parallel training of the port: the process mesh (``mesh``), the ring
transport (``peer``), gradient bucketing (``bucketing``), the data-parallel
train step (``dp``) and the hybrid train step on dp or cp meshes
(``hybrid``)."""
