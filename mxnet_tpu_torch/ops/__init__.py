"""Operator implementations; importing this package registers them."""
from . import nn, conv, matrix, elemwise, optimizer_ops, broadcast  # noqa: F401
