"""The service's wire messages (protos/consensus_overlord.proto), hand
written: the port needs no google.protobuf."""

from . import consensus_overlord_pb2 as pb2  # noqa: F401
