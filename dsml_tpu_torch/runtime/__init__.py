"""The port's host runtime: the native (C++) runtime's bindings
(:mod:`~dsml_tpu_torch.runtime.native`) and the wire-fault plan of the
data plane (:mod:`~dsml_tpu_torch.runtime.chaos`)."""
