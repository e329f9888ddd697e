"""Module API (the classic one-device route of this slice)."""
from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]
