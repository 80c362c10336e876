"""Seeded violation: a ctypes ``argtypes`` list one pointer short.

Parsed by the port's hotlint in tests — never imported.  ``seed_abi.cu``
beside it declares ``seed_kernel`` with three pointers, two ints and the
stream; the list below has two pointers, so HL004 must fire.
"""
import ctypes


def load(path):
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.seed_kernel.argtypes = [p] * 2 + [i] * 2 + [p]
    lib.seed_kernel.restype = i
    return lib
