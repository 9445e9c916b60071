# Declarative experiment layer: frozen configs -> Testbed -> RunReport.
# The API every scenario (benchmark, example) builds on; the port's own copy
# of src/repro/exp/__init__.py.
# Multi-host scenarios: TopologyConfig -> Cluster -> RunReport, under the
# shared-clock loop or the partitioned engines (PARTITION_MODES).
from .config import (AqmConfig, CostConfig, DcaConfig, ExperimentConfig,
                     LinkConfig, NodeConfig, PARTITION_MODES, PipelineConfig,
                     PoolConfig, PortConfig, RssConfig, StackConfig,
                     SwitchConfig, TopologyConfig, TrafficConfig)
from .runner import (make_server_factory, run_experiment,
                     run_topology_experiment, run_testbed)
from .seeding import config_fingerprint, derive_seed
from .testbed import Testbed, build_stack, register_stack, stack_kinds
from .topology import (Client, Cluster, Node, partition_fallback_reason,
                       run_partitioned_topology)

__all__ = [
    "AqmConfig",
    "Client", "Cluster", "CostConfig", "DcaConfig", "ExperimentConfig",
    "LinkConfig", "PipelineConfig",
    "Node", "NodeConfig", "PARTITION_MODES", "PoolConfig", "PortConfig",
    "RssConfig", "StackConfig", "SwitchConfig", "TopologyConfig",
    "TrafficConfig",
    "Testbed", "build_stack", "config_fingerprint", "derive_seed",
    "make_server_factory", "partition_fallback_reason", "register_stack",
    "run_experiment", "run_partitioned_topology", "run_testbed",
    "run_topology_experiment", "stack_kinds",
]
