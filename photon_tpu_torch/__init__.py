"""PyTorch port of photon_tpu for NVIDIA Hopper GPUs.

The package mirrors ``photon_tpu``'s module layout (``core``, ``data``,
``ops``, ``models``, ``evaluation``, ``drivers``) so each counterpart is
easy to find.  It imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing of ``photon_tpu``.  Entry points run on ``cuda`` unless the caller
asks for ``cpu``; see :mod:`photon_tpu_torch.device`.
"""

from photon_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
