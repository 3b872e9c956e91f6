"""The cost model of the paper in the port: the NumPy modules of
``repro.core`` that the grid engine needs, copied with only their imports
changed, and the engine itself.

  alphabeta, collectives, fabric, topology   the clusters and their
               collective-algorithm menus (``make_cluster``, ``FaultSet``)
  hardware     XPU generations (H100, Blackwell, Rubin, TPU v5e)
  compute_model, workload, optable           decode and prefill iterations
               lowered to per-op coefficient tables (``op_table``,
               ``prefill_op_table``)
  overlap, specdec, placement                the DBO lanes, speculative
               decoding and expert-load skew
  scenario     the ``Scenario`` dataclass of ``repro.core.optimizer``
  sweep_torch  the grid engine (``TorchGridEngine``, ``prefill_chunk_times``,
               ``op_load_factors``): the port of ``repro.core.sweep_jax``

The search and selection (``sweep``, ``optimizer``, ``api``, ``traffic``)
stay NumPy-only in the reference and have no copy here.
"""
