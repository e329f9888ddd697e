"""KVStore server role (PyTorch counterpart of
``mxnet_tpu/kvstore_server.py``).

MXNet 0.9.5 dispatches on ``DMLC_ROLE`` at import: ``server`` and
``scheduler`` processes run the parameter-server loop, ``worker``
returns to the user's code. The port has no server processes: every
process is a worker of the ``torch.distributed`` group
(:mod:`mxnet_tpu_torch.dist`), so a server or scheduler role, kept so
that reference launch scripts (``tools/launch.py -s N``) still start,
serves nothing: it logs that and exits 0 at import, as the JAX package's
does.
"""
from __future__ import annotations

import logging
import os
import sys

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


class KVStoreServer(object):
    """The server role's shim: it serves nothing."""

    def __init__(self, kvstore):
        self.kvstore = kvstore
        self.init_logging()

    def init_logging(self):
        if int(os.getenv("MXNET_KVSTORE_DEBUG", "0")) > 0:
            logging.basicConfig(level=logging.DEBUG)

    def run(self):
        logging.info("the kvstore server role serves nothing: workers "
                     "reduce among themselves over the process group")


def _init_kvstore_server_module():
    """Run on import, as in the reference: a server or scheduler role
    runs the (empty) server loop and exits."""
    if os.getenv("DMLC_ROLE", "worker") in ("server", "scheduler"):
        KVStoreServer(None).run()
        sys.exit(0)


_init_kvstore_server_module()
