"""Native runtime support: the SPSC block ring and the ``.fatcube``
decoder of pbso_native.cc, built with g++ at first use (bindings.py)."""
from .bindings import (NativeSpscRing, load_all_fatcubes_native, load_native,
                       native_decode_fatcube)

__all__ = ["NativeSpscRing", "load_all_fatcubes_native", "load_native",
           "native_decode_fatcube"]
