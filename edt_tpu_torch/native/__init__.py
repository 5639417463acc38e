"""Native (C++) host-side components of edt_tpu_torch, loaded via ctypes.

A copy of ``edt_tpu.native``: ``rle.cpp`` is built with g++ at first use
into ``edt_tpu_torch/_build/`` (``build.py``). Where no g++ is on the
PATH, ``edt_tpu_torch.rle`` takes its NumPy path instead.
"""
