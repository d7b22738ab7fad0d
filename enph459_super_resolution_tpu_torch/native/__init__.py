"""Native host codec: libpng decode (one file, or a batch on a thread pool)
and a zlib-level-1 writer, compiled from ``png_loader.cpp`` with ``g++`` at
first use (:mod:`.build`) and bound with ctypes (:mod:`.png_loader`)."""
