"""LUT artifacts: reference-compatible int8 .npy I/O and network→LUT transfer."""
from .io import LUTBank, load_lut_bank, save_lut_bank
from .transfer import lattice_inputs, transfer_to_lut

__all__ = ["LUTBank", "load_lut_bank", "save_lut_bank", "transfer_to_lut",
           "lattice_inputs"]
