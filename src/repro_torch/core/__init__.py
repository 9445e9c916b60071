# The paper's primary contribution: a kernel-bypass network dataplane and a
# hardware load-generator measurement model. The port's own copy of
# src/repro/core/__init__.py: the same exports, from the port's modules.
from .cost import HostCostModel, ZERO_COST, spin_ns
from .dataplane import BypassDataplane, FeedStats, KernelStackFeed, make_feed
from .dca import BurstPlan, OccupancyTrace, run_burst_experiment
from .descriptor import RxDescriptorRing, TxDescriptorRing, STATUS_DONE, STATUS_FREE
from .ethdev import EthConf, EthDev, EthDevError, EthDevState, EthStats
from .fastpath import (EPOCH_FALLBACK_REASONS, EpochRunInfo,
                       PARTITIONED_REASON, run_epoch_sim,
                       validate_epoch_fallback_reason)
from .kernel_stack import KernelStackServer, KernelStats
from .loadgen import (DctcpRateController, LoadGen, TrafficPattern,
                      find_max_sustainable_bandwidth)
from .netstack import Lcore, NetworkStack, ServerStats
from .packet import (
    DEFAULT_MTU,
    DEFAULT_TS_OFFSET,
    ETH_HEADER_SIZE,
    FLOW_OFFSET,
    FLOW_SIZE,
    MIN_FRAME,
    PacketPool,
    PacketRef,
    checksum,
    clear_ce,
    echo_payload_checksum,
    flow_bytes,
    flow_tuple_for_id,
    l2fwd_echo,
    l2fwd_echo_vec,
    payload_checksum,
    read_ce,
    read_ce_vec,
    read_dst_ip,
    read_flow,
    read_flow_bytes,
    read_flow_bytes_vec,
    read_seq,
    read_seqs_vec,
    read_stamp,
    read_stamps_vec,
    set_ce,
    set_ce_vec,
    stamp,
    swap_flow_ips,
    swap_flow_ips_vec,
    swap_macs,
    swap_macs_vec,
    write_flow,
    write_flow_ids_vec,
    write_packets_vec,
    write_seq,
)
from .partition import (PARTITION_FALLBACK_REASONS, CausalityError,
                        ClientDomain, Crossing, DomainScheduler, DomainSwitch,
                        MpPartitionEngine, NodeDomain, PartitionEngine,
                        PartitionRunInfo, PartitionSanitizer, SwitchDomain,
                        assign_groups, validate_partition_fallback_reason)
from .pmd import BypassL2FwdServer, PipelineServer, Port
from .rings import SpscRing
from .simclock import EventScheduler, SimClock, Wire
from .switch import (AqmRed, Switch, SwitchPort, aqm_uniform_u64,
                     red_probability)
from .rss import DEFAULT_RSS_KEY, RssIndirection, toeplitz_hash, toeplitz_hash_vec
from .telemetry import (LatencyRecorder, LatencyStats, QueueTelemetry,
                        RunReport, ThroughputMeter, rss_skew,
                        writeback_extras)

__all__ = [
    "BypassDataplane", "BypassL2FwdServer", "BurstPlan", "CausalityError",
    "ClientDomain",
    "AqmRed", "Crossing", "DctcpRateController", "DomainScheduler",
    "DomainSwitch", "EthConf",
    "EthDev",
    "EPOCH_FALLBACK_REASONS", "EpochRunInfo",
    "EthDevError", "EthDevState", "EthStats", "EventScheduler", "FeedStats",
    "validate_epoch_fallback_reason", "validate_partition_fallback_reason",
    "HostCostModel", "KernelStackFeed", "KernelStackServer", "KernelStats",
    "LatencyRecorder", "LatencyStats", "Lcore", "LoadGen",
    "MpPartitionEngine", "NetworkStack", "NodeDomain",
    "OccupancyTrace", "PARTITIONED_REASON", "PARTITION_FALLBACK_REASONS",
    "PacketPool", "PacketRef",
    "PartitionEngine", "PartitionRunInfo", "PartitionSanitizer",
    "PipelineServer", "Port",
    "QueueTelemetry", "RssIndirection", "RunReport", "RxDescriptorRing",
    "ServerStats", "SimClock", "SpscRing", "Switch", "SwitchDomain",
    "SwitchPort", "aqm_uniform_u64", "red_probability",
    "ThroughputMeter", "TrafficPattern",
    "TxDescriptorRing", "Wire", "ZERO_COST",
    "assign_groups",
    "checksum", "clear_ce", "echo_payload_checksum",
    "find_max_sustainable_bandwidth",
    "flow_bytes",
    "flow_tuple_for_id", "l2fwd_echo", "l2fwd_echo_vec", "make_feed",
    "payload_checksum", "read_ce", "read_ce_vec", "read_dst_ip", "read_flow",
    "read_flow_bytes", "read_flow_bytes_vec", "read_seq", "read_stamp",
    "rss_skew",
    "run_burst_experiment", "run_epoch_sim", "set_ce", "set_ce_vec",
    "spin_ns", "stamp",
    "swap_flow_ips",
    "swap_flow_ips_vec", "swap_macs",
    "toeplitz_hash", "toeplitz_hash_vec", "write_flow", "write_flow_ids_vec",
    "write_seq", "writeback_extras",
    "DEFAULT_MTU", "DEFAULT_RSS_KEY", "DEFAULT_TS_OFFSET", "ETH_HEADER_SIZE",
    "FLOW_OFFSET", "FLOW_SIZE", "MIN_FRAME", "STATUS_DONE", "STATUS_FREE",
]
