# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ray_tpu/protocol/serve.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1cray_tpu/protocol/serve.proto\x12\rray_tpu.serve\"Z\n\x0cServeRequest\x12\x0b\n\x03\x61pp\x18\x01 \x01(\t\x12\x0e\n\x06method\x18\x02 \x01(\t\x12\x0f\n\x07payload\x18\x03 \x01(\x0c\x12\x1c\n\x14multiplexed_model_id\x18\x04 \x01(\t\"\x1d\n\nServeReply\x12\x0f\n\x07payload\x18\x01 \x01(\x0c\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ray_tpu.protocol.serve_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SERVEREQUEST._serialized_start=47
  _SERVEREQUEST._serialized_end=137
  _SERVEREPLY._serialized_start=139
  _SERVEREPLY._serialized_end=168
# @@protoc_insertion_point(module_scope)
