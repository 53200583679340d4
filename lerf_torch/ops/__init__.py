"""Geometry, LUT-stage and resize ops of the port (see the submodules)."""
