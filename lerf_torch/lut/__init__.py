from .io import LUTBank, load_lut_bank, save_lut_bank

__all__ = ["LUTBank", "load_lut_bank", "save_lut_bank"]
