"""The port's C/C++ sources: the output limiter and the C ABI shim.

``build.py`` compiles them with g++/gcc into the package's ``_build/``
directory at first use.
"""
