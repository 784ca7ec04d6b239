"""The blocked-ELL sparse engine (``sharded_ell.py``) on one device.

Twin of ``singlet_tpu/parallel``. The JAX package shards cells over a
device mesh; the port runs the same engine on one card, so its geometry is
that of a one-device mesh. The dense mesh engine (``parallel/sharded.py``),
multi-host ingest and the mesh axis are not ported yet (ROADMAP A.4,
multi-device).
"""
