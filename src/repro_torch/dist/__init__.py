"""The port's one-card part of the JAX package's ``dist/``: error-feedback
gradient compression.  The mesh (``sharding.py``), ``compressed_psum``
(a ``shard_map`` over a mesh axis) and ``pipeline.py`` need several
cards and are not ported."""
