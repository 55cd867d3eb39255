"""Generated protobuf messages of the gpu_sim wire protocol: ``gpu_sim.proto``
and ``gpu_sim_pb2.py``, byte for byte the JAX package's. Both define
``gpu_sim.proto`` in protobuf's default descriptor pool, so an identical
copy loads beside the JAX one in one process (and an edited one would not).

Regenerate with:
    protoc --python_out=dsml_tpu_torch/comm/proto -I dsml_tpu_torch/comm/proto \
        dsml_tpu_torch/comm/proto/gpu_sim.proto
"""
