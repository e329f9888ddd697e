"""Module API: ``Module`` (fused and classic routes on one device) and
``BucketingModule`` over per-bucket classic modules."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "Module", "BucketingModule"]
