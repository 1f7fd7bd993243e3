"""The benchmark's plain reference of ``assemble``: what the port's artifacts
are compared with.

``sketch`` is written for the benchmark in plain torch ops.  The host layers
(``assembly``, ``config``, ``constants``, ``graph_paths``, ``intervals``,
``mingraph``, ``nthash_np``, ``orientation``, ``overlap_region``,
``overlap_trim``, ``pathnode``, ``paths``, ``scaffolder``) are frozen copies of
the port's host route (``index_backend=host``), cut to what that route runs
and with the Python fallbacks in place of the C++ helpers; ``fasta`` reads
whole files in memory.  Nothing here imports the port, ``jax`` or
``ntjoin_tpu``, and nothing takes what the port made.
"""
