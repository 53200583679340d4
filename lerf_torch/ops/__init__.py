"""Geometry, LUT-stage and resize ops of the port (see the submodules)."""
from .resample import resize

__all__ = ["resize"]
