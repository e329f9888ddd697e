"""Module API: ``Module`` (fused and classic routes on one device),
``BucketingModule`` over per-bucket classic modules, ``SequentialModule``
(modules in a chain) and the Python bricks ``PythonModule`` and
``PythonLossModule``."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "PythonModule", "PythonLossModule"]
