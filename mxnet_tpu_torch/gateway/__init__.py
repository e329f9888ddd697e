"""mxnet_tpu_torch.gateway — the network serving plane (the port's
counterpart of ``mxnet_tpu/gateway``).

Everything the serving stack serves in process — ``Predictor`` rows,
``DynamicBatcher`` tenancy, ``DecodeEngine`` token streams,
``ReplicaPool`` autoscale — becomes reachable over a socket, without
giving up any contract:

* :class:`GatewayServer` — the HTTP front door (``/v1/predict``,
  streamed ``/v1/generate``, drain-aware ``/readyz``), edge
  admission (429 + Retry-After off ``QueueFull``/SLO burn), deadline
  propagation (``X-Deadline-Ms`` → backend ``timeout_ms``), graceful
  drain; request rows become tensors on the backend's device;
* :class:`~mxnet_tpu_torch.gateway.router.Router` — least-outstanding
  routing for stateless predict, seeded rendezvous session affinity
  for decode (slot state never migrates; a dead replica re-routes
  deterministically);
* :class:`GatewayClient` — bounded deterministic retries, hedged
  predict with server-side dedupe, streaming generate iterator.

The contracts are inherited, not re-proven: a token stream over HTTP
is byte-identical to the same-seed in-process engine stream, and a
predict reply equals the in-process ``Predictor`` call bit for bit
(tests/test_torch_gateway.py).
"""
from .client import (GatewayBusy, GatewayClient, GatewayError,
                     GatewayStreamError)
from .router import Router
from .server import GATEWAY_TRACE_PHASES, GatewayServer

__all__ = ["GatewayServer", "GatewayClient", "Router",
           "GatewayError", "GatewayBusy", "GatewayStreamError",
           "GATEWAY_TRACE_PHASES"]
