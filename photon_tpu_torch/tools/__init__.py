"""The primitive probes on the card: counterparts of the JAX package's
``tools/probe_permute.py``, ``tools/probe_tiles.py`` and
``tools/probe_blocklocal.py``.  Each is its own entry point::

    python -m photon_tpu_torch.tools.probe_permute [--entries E] [--device cuda|cpu]

and each probe is a function of ``(E, device)`` that prints its row and
returns its seconds, so a script can call it directly.
``check_host_sync`` guards the hot loops against unmarked device reads
(``python -m photon_tpu_torch.tools.check_host_sync``).
"""
