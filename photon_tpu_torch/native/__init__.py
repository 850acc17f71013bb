"""Host C++ code of the port, built with ``g++`` at first use (see
:mod:`photon_tpu_torch.native.build`)."""
