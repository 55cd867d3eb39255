# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: gpu_sim.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rgpu_sim.proto\x12\x07gpu_sim\"\x19\n\x08\x44\x65viceId\x12\r\n\x05value\x18\x01 \x01(\x04\"\x15\n\x04Rank\x12\r\n\x05value\x18\x01 \x01(\r\"\x18\n\x07MemAddr\x12\r\n\x05value\x18\x01 \x01(\x04\"\x19\n\x08StreamId\x12\r\n\x05value\x18\x01 \x01(\x04\"\x81\x01\n\x0e\x44\x65viceMetadata\x12#\n\x08\x64\x65viceId\x18\x01 \x01(\x0b\x32\x11.gpu_sim.DeviceId\x12$\n\nminMemAddr\x18\x02 \x01(\x0b\x32\x10.gpu_sim.MemAddr\x12$\n\nmaxMemAddr\x18\x03 \x01(\x0b\x32\x10.gpu_sim.MemAddr\"\x1a\n\x18GetDeviceMetadataRequest\"F\n\x19GetDeviceMetadataResponse\x12)\n\x08metadata\x18\x01 \x01(\x0b\x32\x17.gpu_sim.DeviceMetadata\"l\n\x10\x42\x65ginSendRequest\x12&\n\x0csendBuffAddr\x18\x01 \x01(\x0b\x32\x10.gpu_sim.MemAddr\x12\x10\n\x08numBytes\x18\x02 \x01(\x04\x12\x1e\n\x07\x64stRank\x18\x03 \x01(\x0b\x32\r.gpu_sim.Rank\"K\n\x11\x42\x65ginSendResponse\x12\x11\n\tinitiated\x18\x01 \x01(\x08\x12#\n\x08streamId\x18\x02 \x01(\x0b\x32\x11.gpu_sim.StreamId\"\x94\x01\n\x13\x42\x65ginReceiveRequest\x12#\n\x08streamId\x18\x01 \x01(\x0b\x32\x11.gpu_sim.StreamId\x12&\n\x0crecvBuffAddr\x18\x02 \x01(\x0b\x32\x10.gpu_sim.MemAddr\x12\x10\n\x08numBytes\x18\x03 \x01(\x04\x12\x1e\n\x07srcRank\x18\x04 \x01(\x0b\x32\r.gpu_sim.Rank\")\n\x14\x42\x65ginReceiveResponse\x12\x11\n\tinitiated\x18\x01 \x01(\x08\"+\n\tDataChunk\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12\x10\n\x08streamId\x18\x02 \x01(\x04\"%\n\x12StreamSendResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\"=\n\x16GetStreamStatusRequest\x12#\n\x08streamId\x18\x01 \x01(\x0b\x32\x11.gpu_sim.StreamId\":\n\x17GetStreamStatusResponse\x12\x1f\n\x06status\x18\x01 \x01(\x0e\x32\x0f.gpu_sim.Status\"\xa9\x01\n\x15\x43onfigurePeersRequest\x12H\n\rpeerAddresses\x18\x01 \x03(\x0b\x32\x31.gpu_sim.ConfigurePeersRequest.PeerAddressesEntry\x12\x10\n\x08selfRank\x18\x02 \x01(\r\x1a\x34\n\x12PeerAddressesEntry\x12\x0b\n\x03key\x18\x01 \x01(\r\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\")\n\x16\x43onfigurePeersResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\"\x83\x01\n\x11RunForwardRequest\x12#\n\x08\x64\x65viceId\x18\x01 \x01(\x0b\x32\x11.gpu_sim.DeviceId\x12#\n\tinputAddr\x18\x02 \x01(\x0b\x32\x10.gpu_sim.MemAddr\x12$\n\noutputAddr\x18\x03 \x01(\x0b\x32\x10.gpu_sim.MemAddr\":\n\x12RunForwardResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x13\n\x0boutputBytes\x18\x02 \x01(\x04\"a\n\x12RunBackwardRequest\x12#\n\x08\x64\x65viceId\x18\x01 \x01(\x0b\x32\x11.gpu_sim.DeviceId\x12&\n\x0cgradientAddr\x18\x02 \x01(\x0b\x32\x10.gpu_sim.MemAddr\"&\n\x13RunBackwardResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\"?\n\x0f\x43ommInitRequest\x12\x12\n\nnumDevices\x18\x01 \x01(\r\x12\x18\n\x10\x64\x65vice_addresses\x18\x02 \x03(\t\"]\n\x10\x43ommInitResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0e\n\x06\x63ommId\x18\x02 \x01(\x04\x12(\n\x07\x64\x65vices\x18\x03 \x03(\x0b\x32\x17.gpu_sim.DeviceMetadata\"@\n\x14GetCommStatusRequest\x12\x0e\n\x06\x63ommId\x18\x01 \x01(\x04\x12\x18\n\x10\x64\x65vice_addresses\x18\x02 \x03(\t\"P\n\nCommMember\x12\x0c\n\x04rank\x18\x01 \x01(\r\x12#\n\x08\x64\x65viceId\x18\x02 \x01(\x0b\x32\x11.gpu_sim.DeviceId\x12\x0f\n\x07\x61\x64\x64ress\x18\x03 \x01(\t\"^\n\x15GetCommStatusResponse\x12\x1f\n\x06status\x18\x01 \x01(\x0e\x32\x0f.gpu_sim.Status\x12$\n\x07members\x18\x02 \x03(\x0b\x32\x13.gpu_sim.CommMember\"#\n\x11GroupStartRequest\x12\x0e\n\x06\x63ommId\x18\x01 \x01(\x04\"%\n\x12GroupStartResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\"!\n\x0fGroupEndRequest\x12\x0e\n\x06\x63ommId\x18\x01 \x01(\x04\"#\n\x10GroupEndResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\"\xe5\x01\n\x14\x41llReduceRingRequest\x12\x0e\n\x06\x63ommId\x18\x01 \x01(\x04\x12\r\n\x05\x63ount\x18\x02 \x01(\x04\x12\x1d\n\x02op\x18\x03 \x01(\x0e\x32\x11.gpu_sim.ReduceOp\x12=\n\x08memAddrs\x18\x04 \x03(\x0b\x32+.gpu_sim.AllReduceRingRequest.MemAddrsEntry\x12\r\n\x05\x64type\x18\x05 \x01(\t\x1a\x41\n\rMemAddrsEntry\x12\x0b\n\x03key\x18\x01 \x01(\r\x12\x1f\n\x05value\x18\x02 \x01(\x0b\x32\x10.gpu_sim.MemAddr:\x02\x38\x01\"(\n\x15\x41llReduceRingResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\"~\n\x19MemcpyHostToDeviceRequest\x12\x13\n\x0bhostSrcData\x18\x01 \x01(\x0c\x12&\n\x0b\x64stDeviceId\x18\x02 \x01(\x0b\x32\x11.gpu_sim.DeviceId\x12$\n\ndstMemAddr\x18\x03 \x01(\x0b\x32\x10.gpu_sim.MemAddr\"-\n\x1aMemcpyHostToDeviceResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\"{\n\x19MemcpyDeviceToHostRequest\x12&\n\x0bsrcDeviceId\x18\x01 \x01(\x0b\x32\x11.gpu_sim.DeviceId\x12$\n\nsrcMemAddr\x18\x02 \x01(\x0b\x32\x10.gpu_sim.MemAddr\x12\x10\n\x08numBytes\x18\x03 \x01(\x04\"-\n\x1aMemcpyDeviceToHostResponse\x12\x0f\n\x07\x64stData\x18\x01 \x01(\x0c\"\x91\x01\n\rMemcpyRequest\x12:\n\x0chostToDevice\x18\x01 \x01(\x0b\x32\".gpu_sim.MemcpyHostToDeviceRequestH\x00\x12:\n\x0c\x64\x65viceToHost\x18\x02 \x01(\x0b\x32\".gpu_sim.MemcpyDeviceToHostRequestH\x00\x42\x08\n\x06\x65ither\"\x94\x01\n\x0eMemcpyResponse\x12;\n\x0chostToDevice\x18\x01 \x01(\x0b\x32#.gpu_sim.MemcpyHostToDeviceResponseH\x00\x12;\n\x0c\x64\x65viceToHost\x18\x02 \x01(\x0b\x32#.gpu_sim.MemcpyDeviceToHostResponseH\x00\x42\x08\n\x06\x65ither\"$\n\x12\x43ommDestroyRequest\x12\x0e\n\x06\x63ommId\x18\x01 \x01(\x04\"&\n\x13\x43ommDestroyResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\"%\n\x13\x43ommFinalizeRequest\x12\x0e\n\x06\x63ommId\x18\x01 \x01(\x04\"\'\n\x14\x43ommFinalizeResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\"L\n\x15NaiveAllReduceRequest\x12\x0e\n\x06\x63ommId\x18\x01 \x01(\x04\x12\x10\n\x08\x64\x61taSize\x18\x02 \x01(\x04\x12\x11\n\tlatencyMs\x18\x03 \x01(\r\"\\\n\x16NaiveAllReduceResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x13\n\x0btotalTimeMs\x18\x02 \x01(\x03\x12\x1c\n\x14totalDataTransferred\x18\x03 \x01(\x03*2\n\x06Status\x12\x0f\n\x0bIN_PROGRESS\x10\x00\x12\x0b\n\x07SUCCESS\x10\x01\x12\n\n\x06\x46\x41ILED\x10\x02*8\n\x08ReduceOp\x12\x07\n\x03SUM\x10\x00\x12\x08\n\x04PROD\x10\x01\x12\x07\n\x03MIN\x10\x02\x12\x07\n\x03MAX\x10\x03\x12\x07\n\x03\x41VG\x10\x04\x32\xc0\x05\n\tGPUDevice\x12\\\n\x11GetDeviceMetadata\x12!.gpu_sim.GetDeviceMetadataRequest\x1a\".gpu_sim.GetDeviceMetadataResponse\"\x00\x12\x44\n\tBeginSend\x12\x19.gpu_sim.BeginSendRequest\x1a\x1a.gpu_sim.BeginSendResponse\"\x00\x12M\n\x0c\x42\x65ginReceive\x12\x1c.gpu_sim.BeginReceiveRequest\x1a\x1d.gpu_sim.BeginReceiveResponse\"\x00\x12\x41\n\nStreamSend\x12\x12.gpu_sim.DataChunk\x1a\x1b.gpu_sim.StreamSendResponse\"\x00(\x01\x12V\n\x0fGetStreamStatus\x12\x1f.gpu_sim.GetStreamStatusRequest\x1a .gpu_sim.GetStreamStatusResponse\"\x00\x12;\n\x06Memcpy\x12\x16.gpu_sim.MemcpyRequest\x1a\x17.gpu_sim.MemcpyResponse\"\x00\x12S\n\x0e\x43onfigurePeers\x12\x1e.gpu_sim.ConfigurePeersRequest\x1a\x1f.gpu_sim.ConfigurePeersResponse\"\x00\x12G\n\nRunForward\x12\x1a.gpu_sim.RunForwardRequest\x1a\x1b.gpu_sim.RunForwardResponse\"\x00\x12J\n\x0bRunBackward\x12\x1b.gpu_sim.RunBackwardRequest\x1a\x1c.gpu_sim.RunBackwardResponse\"\x00\x32\xb0\x05\n\x0eGPUCoordinator\x12\x41\n\x08\x43ommInit\x12\x18.gpu_sim.CommInitRequest\x1a\x19.gpu_sim.CommInitResponse\"\x00\x12P\n\rGetCommStatus\x12\x1d.gpu_sim.GetCommStatusRequest\x1a\x1e.gpu_sim.GetCommStatusResponse\"\x00\x12J\n\x0b\x43ommDestroy\x12\x1b.gpu_sim.CommDestroyRequest\x1a\x1c.gpu_sim.CommDestroyResponse\"\x00\x12M\n\x0c\x43ommFinalize\x12\x1c.gpu_sim.CommFinalizeRequest\x1a\x1d.gpu_sim.CommFinalizeResponse\"\x00\x12G\n\nGroupStart\x12\x1a.gpu_sim.GroupStartRequest\x1a\x1b.gpu_sim.GroupStartResponse\"\x00\x12\x41\n\x08GroupEnd\x12\x18.gpu_sim.GroupEndRequest\x1a\x19.gpu_sim.GroupEndResponse\"\x00\x12P\n\rAllReduceRing\x12\x1d.gpu_sim.AllReduceRingRequest\x1a\x1e.gpu_sim.AllReduceRingResponse\"\x00\x12S\n\x0eNaiveAllReduce\x12\x1e.gpu_sim.NaiveAllReduceRequest\x1a\x1f.gpu_sim.NaiveAllReduceResponse\"\x00\x12;\n\x06Memcpy\x12\x16.gpu_sim.MemcpyRequest\x1a\x17.gpu_sim.MemcpyResponse\"\x00\x42\x08Z\x06/protob\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'gpu_sim_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'Z\006/proto'
  _CONFIGUREPEERSREQUEST_PEERADDRESSESENTRY._options = None
  _CONFIGUREPEERSREQUEST_PEERADDRESSESENTRY._serialized_options = b'8\001'
  _ALLREDUCERINGREQUEST_MEMADDRSENTRY._options = None
  _ALLREDUCERINGREQUEST_MEMADDRSENTRY._serialized_options = b'8\001'
  _STATUS._serialized_start=3299
  _STATUS._serialized_end=3349
  _REDUCEOP._serialized_start=3351
  _REDUCEOP._serialized_end=3407
  _DEVICEID._serialized_start=26
  _DEVICEID._serialized_end=51
  _RANK._serialized_start=53
  _RANK._serialized_end=74
  _MEMADDR._serialized_start=76
  _MEMADDR._serialized_end=100
  _STREAMID._serialized_start=102
  _STREAMID._serialized_end=127
  _DEVICEMETADATA._serialized_start=130
  _DEVICEMETADATA._serialized_end=259
  _GETDEVICEMETADATAREQUEST._serialized_start=261
  _GETDEVICEMETADATAREQUEST._serialized_end=287
  _GETDEVICEMETADATARESPONSE._serialized_start=289
  _GETDEVICEMETADATARESPONSE._serialized_end=359
  _BEGINSENDREQUEST._serialized_start=361
  _BEGINSENDREQUEST._serialized_end=469
  _BEGINSENDRESPONSE._serialized_start=471
  _BEGINSENDRESPONSE._serialized_end=546
  _BEGINRECEIVEREQUEST._serialized_start=549
  _BEGINRECEIVEREQUEST._serialized_end=697
  _BEGINRECEIVERESPONSE._serialized_start=699
  _BEGINRECEIVERESPONSE._serialized_end=740
  _DATACHUNK._serialized_start=742
  _DATACHUNK._serialized_end=785
  _STREAMSENDRESPONSE._serialized_start=787
  _STREAMSENDRESPONSE._serialized_end=824
  _GETSTREAMSTATUSREQUEST._serialized_start=826
  _GETSTREAMSTATUSREQUEST._serialized_end=887
  _GETSTREAMSTATUSRESPONSE._serialized_start=889
  _GETSTREAMSTATUSRESPONSE._serialized_end=947
  _CONFIGUREPEERSREQUEST._serialized_start=950
  _CONFIGUREPEERSREQUEST._serialized_end=1119
  _CONFIGUREPEERSREQUEST_PEERADDRESSESENTRY._serialized_start=1067
  _CONFIGUREPEERSREQUEST_PEERADDRESSESENTRY._serialized_end=1119
  _CONFIGUREPEERSRESPONSE._serialized_start=1121
  _CONFIGUREPEERSRESPONSE._serialized_end=1162
  _RUNFORWARDREQUEST._serialized_start=1165
  _RUNFORWARDREQUEST._serialized_end=1296
  _RUNFORWARDRESPONSE._serialized_start=1298
  _RUNFORWARDRESPONSE._serialized_end=1356
  _RUNBACKWARDREQUEST._serialized_start=1358
  _RUNBACKWARDREQUEST._serialized_end=1455
  _RUNBACKWARDRESPONSE._serialized_start=1457
  _RUNBACKWARDRESPONSE._serialized_end=1495
  _COMMINITREQUEST._serialized_start=1497
  _COMMINITREQUEST._serialized_end=1560
  _COMMINITRESPONSE._serialized_start=1562
  _COMMINITRESPONSE._serialized_end=1655
  _GETCOMMSTATUSREQUEST._serialized_start=1657
  _GETCOMMSTATUSREQUEST._serialized_end=1721
  _COMMMEMBER._serialized_start=1723
  _COMMMEMBER._serialized_end=1803
  _GETCOMMSTATUSRESPONSE._serialized_start=1805
  _GETCOMMSTATUSRESPONSE._serialized_end=1899
  _GROUPSTARTREQUEST._serialized_start=1901
  _GROUPSTARTREQUEST._serialized_end=1936
  _GROUPSTARTRESPONSE._serialized_start=1938
  _GROUPSTARTRESPONSE._serialized_end=1975
  _GROUPENDREQUEST._serialized_start=1977
  _GROUPENDREQUEST._serialized_end=2010
  _GROUPENDRESPONSE._serialized_start=2012
  _GROUPENDRESPONSE._serialized_end=2047
  _ALLREDUCERINGREQUEST._serialized_start=2050
  _ALLREDUCERINGREQUEST._serialized_end=2279
  _ALLREDUCERINGREQUEST_MEMADDRSENTRY._serialized_start=2214
  _ALLREDUCERINGREQUEST_MEMADDRSENTRY._serialized_end=2279
  _ALLREDUCERINGRESPONSE._serialized_start=2281
  _ALLREDUCERINGRESPONSE._serialized_end=2321
  _MEMCPYHOSTTODEVICEREQUEST._serialized_start=2323
  _MEMCPYHOSTTODEVICEREQUEST._serialized_end=2449
  _MEMCPYHOSTTODEVICERESPONSE._serialized_start=2451
  _MEMCPYHOSTTODEVICERESPONSE._serialized_end=2496
  _MEMCPYDEVICETOHOSTREQUEST._serialized_start=2498
  _MEMCPYDEVICETOHOSTREQUEST._serialized_end=2621
  _MEMCPYDEVICETOHOSTRESPONSE._serialized_start=2623
  _MEMCPYDEVICETOHOSTRESPONSE._serialized_end=2668
  _MEMCPYREQUEST._serialized_start=2671
  _MEMCPYREQUEST._serialized_end=2816
  _MEMCPYRESPONSE._serialized_start=2819
  _MEMCPYRESPONSE._serialized_end=2967
  _COMMDESTROYREQUEST._serialized_start=2969
  _COMMDESTROYREQUEST._serialized_end=3005
  _COMMDESTROYRESPONSE._serialized_start=3007
  _COMMDESTROYRESPONSE._serialized_end=3045
  _COMMFINALIZEREQUEST._serialized_start=3047
  _COMMFINALIZEREQUEST._serialized_end=3084
  _COMMFINALIZERESPONSE._serialized_start=3086
  _COMMFINALIZERESPONSE._serialized_end=3125
  _NAIVEALLREDUCEREQUEST._serialized_start=3127
  _NAIVEALLREDUCEREQUEST._serialized_end=3203
  _NAIVEALLREDUCERESPONSE._serialized_start=3205
  _NAIVEALLREDUCERESPONSE._serialized_end=3297
  _GPUDEVICE._serialized_start=3410
  _GPUDEVICE._serialized_end=4114
  _GPUCOORDINATOR._serialized_start=4117
  _GPUCOORDINATOR._serialized_end=4805
# @@protoc_insertion_point(module_scope)
