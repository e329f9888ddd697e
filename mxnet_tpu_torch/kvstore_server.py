"""KVStore server role (PyTorch counterpart of
``mxnet_tpu/kvstore_server.py``).

MXNet 0.9.5 dispatches on ``DMLC_ROLE`` at import: ``server`` and
``scheduler`` processes run the parameter-server loop, ``worker``
returns to the user's code. The port has no multi-process runtime yet
(ROADMAP A8): a worker imports this module as a no-op, and a server or
scheduler role raises ``MXNetError`` instead of idling.
"""
from __future__ import annotations

import logging
import os

from .base import MXNetError

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


class KVStoreServer(object):
    """The server role's shim: it serves nothing in one process."""

    def __init__(self, kvstore):
        self.kvstore = kvstore
        self.init_logging()

    def init_logging(self):
        if int(os.getenv("MXNET_KVSTORE_DEBUG", "0")) > 0:
            logging.basicConfig(level=logging.DEBUG)

    def run(self):
        raise MXNetError("the kvstore server role comes with the "
                         "distributed slice (ROADMAP A8) of the port")


def _init_kvstore_server_module():
    """Run on import, as in the reference: a server or scheduler role
    runs the server (here: refuses)."""
    if os.getenv("DMLC_ROLE", "worker") in ("server", "scheduler"):
        KVStoreServer(None).run()


_init_kvstore_server_module()
