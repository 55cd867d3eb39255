"""gRPC service bindings for the gpu_sim protocol, built by hand — the
port's copy of ``dsml_tpu/comm/rpc.py``.

The service layer is declared from method tables and wired through grpc's
generic-handler API (no ``*_pb2_grpc.py`` plugin needed). Same RPC paths on
the wire (``/gpu_sim.GPUDevice/...``) as the reference's generated stubs, so
the JAX package's peers, the port's and the reference's interoperate.
"""

from __future__ import annotations

import grpc

from dsml_tpu_torch.comm.proto import gpu_sim_pb2 as pb

# method name -> (arity, request type, response type)
# arity: "uu" = unary-unary, "su" = stream-unary
_DEVICE_METHODS = {
    "GetDeviceMetadata": ("uu", pb.GetDeviceMetadataRequest, pb.GetDeviceMetadataResponse),
    "BeginSend": ("uu", pb.BeginSendRequest, pb.BeginSendResponse),
    "BeginReceive": ("uu", pb.BeginReceiveRequest, pb.BeginReceiveResponse),
    "StreamSend": ("su", pb.DataChunk, pb.StreamSendResponse),
    "GetStreamStatus": ("uu", pb.GetStreamStatusRequest, pb.GetStreamStatusResponse),
    "Memcpy": ("uu", pb.MemcpyRequest, pb.MemcpyResponse),
    "ConfigurePeers": ("uu", pb.ConfigurePeersRequest, pb.ConfigurePeersResponse),
    "RunForward": ("uu", pb.RunForwardRequest, pb.RunForwardResponse),
    "RunBackward": ("uu", pb.RunBackwardRequest, pb.RunBackwardResponse),
}

_COORDINATOR_METHODS = {
    "CommInit": ("uu", pb.CommInitRequest, pb.CommInitResponse),
    "GetCommStatus": ("uu", pb.GetCommStatusRequest, pb.GetCommStatusResponse),
    "CommDestroy": ("uu", pb.CommDestroyRequest, pb.CommDestroyResponse),
    "CommFinalize": ("uu", pb.CommFinalizeRequest, pb.CommFinalizeResponse),
    "GroupStart": ("uu", pb.GroupStartRequest, pb.GroupStartResponse),
    "GroupEnd": ("uu", pb.GroupEndRequest, pb.GroupEndResponse),
    "AllReduceRing": ("uu", pb.AllReduceRingRequest, pb.AllReduceRingResponse),
    "NaiveAllReduce": ("uu", pb.NaiveAllReduceRequest, pb.NaiveAllReduceResponse),
    "Memcpy": ("uu", pb.MemcpyRequest, pb.MemcpyResponse),
}

# Observability plane — an EXTENSION service carrying raw JSON bytes
# (req/resp class None = no protobuf codec: grpc passes bytes through).
# The reference proto stays byte-for-byte untouched; reference peers never
# call it, and our peers that lack it just fail the obs scrape, never the
# data plane. Workers (device servers, the coordinator) attach it to the
# grpc.Server they already run, so the cluster aggregator pulls snapshots
# over the SAME port/channel as the gpu_sim traffic.
_OBS_METHODS = {
    "PullSnapshot": ("uu", None, None),
    "PushSnapshot": ("uu", None, None),
}

# Shard-migration control plane — a second raw-JSON extension service
# (same pattern as ObsPlane; reference proto untouched). Only the CONTROL
# messages ride here: which pieces a donor holds (PlanPieces) and the
# request to serialize + BeginSend them (BeginMigration, whose response
# carries stream ids and CRC32C frame checksums). The piece BYTES move
# over the gpu_sim P2P stream RPCs the donor initiates.
_MIGRATION_METHODS = {
    "PlanPieces": ("uu", None, None),
    "BeginMigration": ("uu", None, None),
}

_SERVICES = {
    "gpu_sim.GPUDevice": _DEVICE_METHODS,
    "gpu_sim.GPUCoordinator": _COORDINATOR_METHODS,
    "dsml_obs.ObsPlane": _OBS_METHODS,
    "dsml_migrate.ShardMigration": _MIGRATION_METHODS,
}


def add_servicer_to_server(service_name: str, servicer, server: grpc.Server) -> None:
    """Register ``servicer`` (an object with one method per RPC) on ``server``."""
    methods = _SERVICES[service_name]
    handlers = {}
    for name, (arity, req_cls, resp_cls) in methods.items():
        fn = getattr(servicer, name)
        deser = req_cls.FromString if req_cls is not None else None
        ser = resp_cls.SerializeToString if resp_cls is not None else None
        if arity == "uu":
            handlers[name] = grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=deser, response_serializer=ser
            )
        else:
            handlers[name] = grpc.stream_unary_rpc_method_handler(
                fn, request_deserializer=deser, response_serializer=ser
            )
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(service_name, handlers),))


class _Stub:
    """Client stub: one callable per RPC, matching generated-stub ergonomics."""

    def __init__(self, channel: grpc.Channel, service_name: str):
        self._channel = channel  # retained so owners can close() on replace
        for name, (arity, req_cls, resp_cls) in _SERVICES[service_name].items():
            path = f"/{service_name}/{name}"
            ser = req_cls.SerializeToString if req_cls is not None else None
            deser = resp_cls.FromString if resp_cls is not None else None
            if arity == "uu":
                callable_ = channel.unary_unary(
                    path, request_serializer=ser, response_deserializer=deser
                )
            else:
                callable_ = channel.stream_unary(
                    path, request_serializer=ser, response_deserializer=deser
                )
            setattr(self, name, callable_)


def device_stub(channel: grpc.Channel) -> _Stub:
    return _Stub(channel, "gpu_sim.GPUDevice")


def coordinator_stub(channel: grpc.Channel) -> _Stub:
    return _Stub(channel, "gpu_sim.GPUCoordinator")


def obs_stub(channel: grpc.Channel) -> _Stub:
    return _Stub(channel, "dsml_obs.ObsPlane")


def add_device_servicer(servicer, server: grpc.Server) -> None:
    add_servicer_to_server("gpu_sim.GPUDevice", servicer, server)


def add_coordinator_servicer(servicer, server: grpc.Server) -> None:
    add_servicer_to_server("gpu_sim.GPUCoordinator", servicer, server)


def add_obs_servicer(servicer, server: grpc.Server) -> None:
    add_servicer_to_server("dsml_obs.ObsPlane", servicer, server)


def migration_stub(channel: grpc.Channel) -> _Stub:
    return _Stub(channel, "dsml_migrate.ShardMigration")


def add_migration_servicer(servicer, server: grpc.Server) -> None:
    add_servicer_to_server("dsml_migrate.ShardMigration", servicer, server)
