"""The consensus microservice: config, the Consensus core, the Brain over
the controller and network siblings, the RPC transports and server, and
the process bootstrap.

The port's own copy of consensus_overlord_tpu/service/ (the port imports
nothing of the JAX package).  `grpc` is imported only when the gRPC wire
is built (rpc.GrpcTransport and the server interceptors);
`google.protobuf` and `prometheus_client` are never imported.
"""
