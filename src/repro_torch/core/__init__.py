"""The cost model of the paper in the port: every NumPy module of
``repro.core``, copied with only their imports changed, and the grid
engine that evaluates the search on the card.

  alphabeta, collectives, fabric, topology   the clusters and their
               collective-algorithm menus (``make_cluster``, ``FaultSet``)
  hardware     XPU generations (H100, Blackwell, Rubin, TPU v5e)
  compute_model, workload, optable           decode and prefill iterations
               lowered to per-op coefficient tables (``op_table``,
               ``prefill_op_table``)
  overlap, specdec, placement                the DBO lanes, speculative
               decoding and expert-load skew
  scenario     the ``Scenario`` dataclass (``repro.core.optimizer``'s;
               ``optimizer`` re-exports it)
  sweep_torch  the grid engine (``TorchGridEngine``, ``prefill_chunk_times``,
               ``op_load_factors``): the port of ``repro.core.sweep_jax``
  sweep        the batched operating-point search; its backends are
               "numpy" (the reference arithmetic) and "torch" (the default:
               ``sweep_torch`` on the card, or on the CPU after
               ``sweep.set_default_device("cpu")``)
  optimizer    max-throughput-under-SLO selection, the scalar reference
               paths and the remap-vs-degrade policy
  api          the public search surface: ``SearchSpec`` + ``solve`` /
               ``solve_grid`` / ``solve_levels`` / ``tpot_curve``
  tco          CapEx/OpEx cluster cost and throughput per cost
  availability component MTBF/MTTR -> stationary expected throughput
  pareto       performance-vs-cost sweep + Pareto frontier (Fig 17)
  future       Blackwell/Rubin saturating-bandwidth projection (Fig 18/19)
  traffic      the cluster-scale continuous-batching traffic simulator

Where the reference differs: ``sweep`` has the torch backend in place of
the JAX one and reads no environment variable; ``Scenario`` is defined
once, in ``scenario``.
"""
from repro_torch.core.alphabeta import AlphaBeta, INTRA_NODE, INTER_NODE, CLUSTER
from repro_torch.core.api import (ReproDeprecationWarning, SearchSpec, Solution,
                                  solve, solve_grid, solve_levels, tpot_curve)
from repro_torch.core.availability import (AvailabilityModel, ComponentClass,
                                           build_availability)
from repro_torch.core.fabric import FABRICS, Fabric, get_fabric, register_fabric
from repro_torch.core.hardware import (H100, BLACKWELL, RUBIN, TPU_V5E, GENERATIONS,
                                       XPUSpec)
from repro_torch.core.optimizer import (Scenario, SCENARIOS, best_of_opts,
                                        best_of_opts_scalar, max_throughput,
                                        max_throughput_prefill,
                                        max_throughput_scalar, degrade_policy,
                                        DegradedPlan, PrefillOperatingPoint)
from repro_torch.core.specdec import SpecDecConfig
from repro_torch.core.sweep import (degraded_max_throughput, parallelism_candidates,
                                    set_default_backend, set_default_device)
from repro_torch.core.sweep_torch import TorchGridEngine, prefill_chunk_times
from repro_torch.core.topology import (Cluster, FaultSet, make_cluster,
                                       TOPOLOGIES)
from repro_torch.core.traffic import (AutoscalePolicy, Catalog, FaultPlan,
                                      TraceSpec, TrafficResult,
                                      best_provisioning, build_catalog,
                                      fleet_cost, generate_trace,
                                      seeded_fault_plan, simulate_trace)
from repro_torch.core.tco import (availability_adjusted_throughput_per_cost,
                                  cluster_tco, throughput_per_cost)
from repro_torch.core.workload import ServingPoint
