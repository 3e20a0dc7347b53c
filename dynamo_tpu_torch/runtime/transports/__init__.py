"""Transports: frame codec, control-plane hub, TCP service plane.

Reference equivalents: lib/runtime/src/transports/{etcd,nats,zmq}.rs and
lib/runtime/src/pipeline/network/**.  One self-contained hub process
(discovery KV with leases + pub/sub + queues) stands in for etcd and NATS,
and requests ride direct TCP with streamed responses on one connection.
"""
