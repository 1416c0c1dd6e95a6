# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ray_tpu/protocol/ray_tpu.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1eray_tpu/protocol/ray_tpu.proto\x12\x10ray_tpu.protocol"-\n\x0cNodeAffinity\x12\x0f\n\x07node_id\x18\x01 \x01(\t\x12\x0c\n\x04soft\x18\x02 \x01(\x08"g\n\x16PlacementGroupStrategy\x12\x1a\n\x12placement_group_id\x18\x01 \x01(\x0c\x12\x14\n\x0cbundle_index\x18\x02 \x01(\x05\x12\x1b\n\x13capture_child_tasks\x18\x03 \x01(\x08"o\n\nNodeLabels\x124\n\x04hard\x18\x01 \x03(\x0b2&.ray_tpu.protocol.NodeLabels.HardEntry\x1a+\n\tHardEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x028\x01"\xf8\x01\n\x12SchedulingStrategy\x12\x11\n\x07default\x18\x01 \x01(\x08H\x00\x12\x10\n\x06spread\x18\x02 \x01(\x08H\x00\x127\n\rnode_affinity\x18\x03 \x01(\x0b2\x1e.ray_tpu.protocol.NodeAffinityH\x00\x12C\n\x0fplacement_group\x18\x04 \x01(\x0b2(.ray_tpu.protocol.PlacementGroupStrategyH\x00\x123\n\x0bnode_labels\x18\x05 \x01(\x0b2\x1c.ray_tpu.protocol.NodeLabelsH\x00B\n\n\x08strategy"\xbe\x04\n\x0bTaskOptions\x12\x15\n\x08num_cpus\x18\x01 \x01(\x01H\x00\x88\x01\x01\x12\x15\n\x08num_gpus\x18\x02 \x01(\x01H\x01\x88\x01\x01\x12\x15\n\x08num_tpus\x18\x03 \x01(\x01H\x02\x88\x01\x01\x12?\n\tresources\x18\x04 \x03(\x0b2,.ray_tpu.protocol.TaskOptions.ResourcesEntry\x12\x13\n\x0bnum_returns\x18\x05 \x01(\x03\x12\x13\n\x0bmax_retries\x18\x06 \x01(\x05\x12\x18\n\x10retry_exceptions\x18\x07 \x01(\x08\x12!\n\x19retry_exception_allowlist\x18\x08 \x01(\x0c\x12\x0c\n\x04name\x18\t \x01(\t\x12A\n\x13scheduling_strategy\x18\n \x01(\x0b2$.ray_tpu.protocol.SchedulingStrategy\x12\x13\n\x0bruntime_env\x18\x0b \x01(\x0c\x12\x14\n\x0cmax_restarts\x18\x0c \x01(\x05\x12\x18\n\x10max_task_retries\x18\r \x01(\x05\x12\x17\n\x0fmax_concurrency\x18\x0e \x01(\x05\x12\x10\n\x08lifetime\x18\x0f \x01(\t\x12\x11\n\tnamespace\x18\x10 \x01(\t\x12\x15\n\rget_if_exists\x18\x11 \x01(\x08\x1a0\n\x0eResourcesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x028\x01B\x0b\n\t_num_cpusB\x0b\n\t_num_gpusB\x0b\n\t_num_tpus"\xfe\x04\n\x08TaskSpec\x12\x0f\n\x07task_id\x18\x01 \x01(\x0c\x12\x0e\n\x06job_id\x18\x02 \x01(\x0c\x12-\n\ttask_type\x18\x03 \x01(\x0e2\x1a.ray_tpu.protocol.TaskType\x12\x14\n\x0cfunc_payload\x18\x04 \x01(\x0c\x12\x10\n\x08arg_refs\x18\x05 \x03(\x0c\x12\x13\n\x0bnum_returns\x18\x06 \x01(\x03\x12\x12\n\nreturn_ids\x18\x07 \x03(\x0c\x12<\n\tresources\x18\x08 \x03(\x0b2).ray_tpu.protocol.TaskSpec.ResourcesEntry\x12.\n\x07options\x18\t \x01(\x0b2\x1d.ray_tpu.protocol.TaskOptions\x12\x0c\n\x04name\x18\n \x01(\t\x12\x10\n\x08actor_id\x18\x0b \x01(\x0c\x12\x13\n\x0bmethod_name\x18\x0c \x01(\t\x12\x17\n\x0fsequence_number\x18\r \x01(\x04\x12?\n\x0bmethod_meta\x18\x0e \x03(\x0b2*.ray_tpu.protocol.TaskSpec.MethodMetaEntry\x12\x16\n\x0eattempt_number\x18\x0f \x01(\r\x12\x15\n\rowner_address\x18\x10 \x01(\t\x12\r\n\x05depth\x18\x11 \x01(\r\x12\x16\n\x0eparent_task_id\x18\x12 \x01(\x0c\x12\x19\n\x08trace_id\x18\x13 \x01(\tR\x07traceId\x1a0\n\x0eResourcesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x028\x01\x1a1\n\x0fMethodMetaEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x03:\x028\x01*D\n\x08TaskType\x12\x0f\n\x0bNORMAL_TASK\x10\x00\x12\x17\n\x13ACTOR_CREATION_TASK\x10\x01\x12\x0e\n\nACTOR_TASK\x10\x02b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ray_tpu.protocol.ray_tpu_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _NODELABELS_HARDENTRY._options = None
  _NODELABELS_HARDENTRY._serialized_options = b'8\001'
  _TASKOPTIONS_RESOURCESENTRY._options = None
  _TASKOPTIONS_RESOURCESENTRY._serialized_options = b'8\001'
  _TASKSPEC_RESOURCESENTRY._options = None
  _TASKSPEC_RESOURCESENTRY._serialized_options = b'8\001'
  _TASKSPEC_METHODMETAENTRY._options = None
  _TASKSPEC_METHODMETAENTRY._serialized_options = b'8\001'
  _TASKTYPE._serialized_start=1786
  _TASKTYPE._serialized_end=1854
  _NODEAFFINITY._serialized_start=52
  _NODEAFFINITY._serialized_end=97
  _PLACEMENTGROUPSTRATEGY._serialized_start=99
  _PLACEMENTGROUPSTRATEGY._serialized_end=202
  _NODELABELS._serialized_start=204
  _NODELABELS._serialized_end=315
  _NODELABELS_HARDENTRY._serialized_start=272
  _NODELABELS_HARDENTRY._serialized_end=315
  _SCHEDULINGSTRATEGY._serialized_start=318
  _SCHEDULINGSTRATEGY._serialized_end=566
  _TASKOPTIONS._serialized_start=569
  _TASKOPTIONS._serialized_end=1143
  _TASKOPTIONS_RESOURCESENTRY._serialized_start=1056
  _TASKOPTIONS_RESOURCESENTRY._serialized_end=1104
  _TASKSPEC._serialized_start=1146
  _TASKSPEC._serialized_end=1784
  _TASKSPEC_RESOURCESENTRY._serialized_start=1056
  _TASKSPEC_RESOURCESENTRY._serialized_end=1104
  _TASKSPEC_METHODMETAENTRY._serialized_start=1735
  _TASKSPEC_METHODMETAENTRY._serialized_end=1784
# @@protoc_insertion_point(module_scope)
