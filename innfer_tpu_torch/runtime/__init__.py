"""The port's native host runtime: a C++ PNG/JPEG codec and a prefetch
loader, bound with ctypes (``native.py``)."""
