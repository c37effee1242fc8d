"""Hand-written CUDA kernels of the port (``csrc/``), their ctypes
wrappers, their plain-torch twins (``ref``) and the device dispatch
(``ops``)."""
