"""The wire: the gpu_sim control plane of the port — the counterpart of
``dsml_tpu/comm``.

  proto/            the wire protocol (gpu_sim.proto + its generated pb2)
  rpc.py            service tables, stubs and servicer registration
  device_server.py  one device server: uint8 buffers on a torch device,
                    P2P streams, RunForward / RunBackward
  coordinator.py    communicator lifecycle, group ops, AllReduceRing,
                    the health loop
  client.py         the training client (PipelineClient)
  migration.py      shard migration over the P2P streams (StateDonor,
                    ShardMigrator)

Nothing here imports grpc when its module is imported except ``rpc.py``
(and what imports it): the runtime classes of the device server and the
coordinator are callable without it.
"""
