"""Hand-written CUDA C++ kernels for Hopper (``sm_90a``) and the code that compiles them.

Sources live beside this file and are compiled by :mod:`.build` at first
use; nothing here compiles or loads anything when imported.
"""
